"""Architecture configs.  Importing this package registers every ported arch
(so far the dense qwen2-0.5b and the ssm rwkv6-3b)."""
from repro_torch.configs import qwen2_0_5b  # noqa: F401
from repro_torch.configs import rwkv6_3b  # noqa: F401
