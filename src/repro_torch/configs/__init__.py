"""Architecture registry: ``get(name)`` / ``get_reduced(name)``.

The dense configs, the GQA MoE config, the VLM (paligemma), and the
recurrent (rwkv6) and hybrid (zamba2) configs are ported; the reference's
other four architectures wait for their families (ROADMAP queue 1, item 9:
MLA and MTP for deepseek-v3, the audio family, and the other configs).
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = ("glm4_9b", "paligemma_3b", "qwen3_moe_235b_a22b", "rwkv6_7b",
         "stablelm_3b", "zamba2_1_2b")

# CLI ids (--arch) use dashes, matching the reference
CLI_IDS = {a.replace("_", "-"): a for a in ARCHS}


def _module(name: str):
    mod = CLI_IDS.get(name, name)
    if mod not in ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ported: "
            f"{', '.join(all_archs())}): its family waits in ROADMAP queue 1, "
            f"item 9 (MLA and MTP, the audio family)")
    return importlib.import_module(f"{__name__}.{mod}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED


def all_archs():
    return [a.replace("_", "-") for a in ARCHS]
