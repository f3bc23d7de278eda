"""TENET serving in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of the JAX package `repro`, kept beside it as the reference.  The
port imports neither JAX nor `repro`; its tests feed both packages the same
numpy inputs and compare.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version (kernels/ref.py).
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says "cpu".

    Raises when CUDA is asked for (explicitly or by default) and absent —
    nothing carries on quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):   # meta: shapes only (ShardingPlan)
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
