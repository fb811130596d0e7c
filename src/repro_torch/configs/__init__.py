"""Architecture config registry — ``--arch <id>`` resolution.

Each module defines the exact published CONFIG plus a ``reduced()`` smoke
variant of the same family (same block pattern, tiny dims), as data: the
same names and values as the reference's ``repro.configs``, on the port's
:class:`~repro_torch.models.transformer.ArchConfig` (torch dtypes).  The
port's model runs every one of them.  :data:`ARCH_NAMES` lists those ten;
:data:`PORT_ARCH_NAMES` the port's own, which the reference has no
counterpart of (``moonlight-16b-a3b``, ``kimi-linear-48b-a3b``);
:func:`get_config` resolves
either.
"""
from __future__ import annotations

from typing import List

from repro_torch.models.transformer import ArchConfig

from repro_torch.configs import (  # noqa: E402
    internvl2_26b,
    jamba_1_5_large_398b,
    kimi_linear_48b_a3b,
    minitron_4b,
    mixtral_8x22b,
    moonlight_16b_a3b,
    moonshot_v1_16b_a3b,
    qwen1_5_4b,
    qwen2_1_5b,
    smollm_360m,
    whisper_base,
    xlstm_1_3b,
)

_MODULES = {
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "mixtral-8x22b": mixtral_8x22b,
    "xlstm-1.3b": xlstm_1_3b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "qwen1.5-4b": qwen1_5_4b,
    "minitron-4b": minitron_4b,
    "smollm-360m": smollm_360m,
    "qwen2-1.5b": qwen2_1_5b,
    "internvl2-26b": internvl2_26b,
    "whisper-base": whisper_base,
}

_PORT_MODULES = {
    "moonlight-16b-a3b": moonlight_16b_a3b,
    "kimi-linear-48b-a3b": kimi_linear_48b_a3b,
}

ARCH_NAMES: List[str] = list(_MODULES)
PORT_ARCH_NAMES: List[str] = list(_PORT_MODULES)


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    mod = _MODULES.get(name) or _PORT_MODULES.get(name)
    if mod is None:
        raise KeyError(f"unknown arch {name!r}; one of "
                       f"{ARCH_NAMES + PORT_ARCH_NAMES}")
    return mod.reduced() if reduced else mod.CONFIG

