"""Model step: the model operations of the tokens the window processed, as
the driver counts them with ``counts/`` (the linear layers of every token
fed, attention over each token's actual context; a prefill's head on its
last position), as a share (%) of the window's seconds at the chip's bf16
peak."""


def read(rec, metric):
    return 100.0 * rec["model_flops"] / (rec["window_s"] * rec["counts"].PEAKS["bf16_flops_per_s"])
