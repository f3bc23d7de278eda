"""Architecture registry of the port: `get_config("<arch-id>")` / `--arch <id>`.

Only the architectures the port serves are registered; the rest of the JAX
package's zoo waits for later slices (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

from importlib import import_module

from .base import ModelConfig, reduced  # noqa: F401

ARCH_MODULES = {
    "bitnet-1.3b": "bitnet_1p3b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port serves "
                       f"{sorted(ARCH_MODULES)}")
    return import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}").CONFIG
