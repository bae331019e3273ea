"""Architecture registry: ``get(name)`` / ``get_reduced(name)``.

All ten of the reference's configs: the dense configs, the GQA MoE config,
the MLA MoE config (deepseek-v3), the VLM (paligemma), the audio encoder
(hubert-xlarge), and the recurrent (rwkv6) and hybrid (zamba2) configs.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = ("command_r_plus_104b", "deepseek_v3_671b", "glm4_9b",
         "hubert_xlarge", "paligemma_3b", "qwen1_5_110b",
         "qwen3_moe_235b_a22b", "rwkv6_7b", "stablelm_3b", "zamba2_1_2b")

# CLI ids (--arch) use dashes, matching the reference
CLI_IDS = {a.replace("_", "-"): a for a in ARCHS}


def _module(name: str):
    mod = CLI_IDS.get(name, name)
    if mod not in ARCHS:
        raise KeyError(f"unknown architecture {name!r} (the reference's: "
                       f"{', '.join(all_archs())})")
    return importlib.import_module(f"{__name__}.{mod}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED


def all_archs():
    return [a.replace("_", "-") for a in ARCHS]
