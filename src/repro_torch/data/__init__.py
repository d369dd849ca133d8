from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_batch  # noqa: F401
