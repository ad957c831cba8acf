from repro_torch.data.pipeline import lm_batch, niah_batch, token_stream  # noqa: F401
