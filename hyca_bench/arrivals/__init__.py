"""One module per arrival process of a served mix
(``arrivals/<process>.py``), found by the mix's ``arrival.process``.  Each
has ``Arrivals(params, seed)`` whose ``due(now, completed)`` gives the due
times of the requests to send at host time ``now``; a request due in the
future is sent once the host clock passes it."""
