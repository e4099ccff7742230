"""Architecture configs.  Importing this package registers every ported arch
(the dense dev architecture qwen2-0.5b, so far)."""
from repro_torch.configs import qwen2_0_5b  # noqa: F401
