"""Architecture config registry: ``get_config(arch_id)`` / ``list_archs()``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig, MoEConfig, SSMConfig

# arch-id -> module name
_ARCH_MODULES = {
    "whisper-base":           "whisper_base",
    "phi3.5-moe-42b-a6.6b":   "phi3_5_moe_42b_a6_6b",
    "qwen2.5-3b":             "qwen2_5_3b",
    "deepseek-7b":            "deepseek_7b",
    "qwen2-vl-7b":            "qwen2_vl_7b",
    "mamba2-130m":            "mamba2_130m",
    "zamba2-1.2b":            "zamba2_1_2b",
    "grok-1-314b":            "grok_1_314b",
    "smollm-360m":            "smollm_360m",
    "phi3-medium-14b":        "phi3_medium_14b",
}

# the paper's own Section 4.1 benchmark models (selectable, not part of the
# assigned 10-arch dry-run matrix)
_PAPER_MODULES = {
    "llama2-7b":  "llama2_7b",
    "mistral-7b": "mistral_7b",
    "falcon-7b":  "falcon_7b",
}
# served configurations beyond both lists (the serving benchmark's)
_SERVE_MODULES = {
    "nemotron-3-nano-30b-a3b": "nemotron_3_nano_30b_a3b",
}
_ARCH_MODULES.update(_PAPER_MODULES)
_ARCH_MODULES.update(_SERVE_MODULES)


def list_archs() -> list[str]:
    """The 10 assigned architectures (dry-run / smoke matrix)."""
    return [a for a in _ARCH_MODULES
            if a not in _PAPER_MODULES and a not in _SERVE_MODULES]


def list_paper_archs() -> list[str]:
    return list(_PAPER_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown input shape {name!r}; available: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


def supports_shape(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch, shape) is a supported combination; returns (ok, reason)."""
    if shape.name == "long_500k":
        if cfg.family == "audio":
            return False, ("enc-dec decoder context is bounded by design (448 positions in "
                           "whisper); 500k-token decode is architecturally meaningless — see "
                           "DESIGN.md shape-coverage notes")
        # sub-quadratic requirement: SSM/hybrid are natively fine; attention archs
        # run via the sliding-window variant (enabled automatically by the launcher).
        return True, "ssm/hybrid native or sliding-window attention variant"
    return True, ""


__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "InputShape", "INPUT_SHAPES",
    "get_config", "get_shape", "list_archs", "supports_shape",
]
