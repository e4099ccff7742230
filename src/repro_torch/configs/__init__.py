"""Architecture configs.  Importing this package registers every arch of
``repro.configs``: the dense qwen2-0.5b, qwen2-7b, yi-6b, nemotron-4-340b
and phi-3-vision-4.2b, the paper's own OPT-13B/30B/66B and RoBERTa-large,
the moe mixtral-8x7b and granite-moe-3b-a800m, the ssm rwkv6-3b, the
hybrid hymba-1.5b and the encdec whisper-large-v3."""
from repro_torch.configs import (granite_moe_3b_a800m, hymba_1_5b,
                                 mixtral_8x7b, nemotron_4_340b, opt_13b,
                                 opt_30b, opt_66b, phi_3_vision_4_2b,
                                 qwen2_0_5b, qwen2_7b, roberta_large,
                                 rwkv6_3b, whisper_large_v3,
                                 yi_6b)  # noqa: F401
from repro_torch.configs.shapes import ASSIGNED_ARCHS, PAPER_ARCHS

__all__ = ["ASSIGNED_ARCHS", "PAPER_ARCHS"]
