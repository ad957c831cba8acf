from repro_torch.ckpt.checkpoint import (  # noqa: F401
    latest_step,
    load_numpy,
    prune_old,
    restore,
    save,
)
