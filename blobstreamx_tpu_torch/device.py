"""Device selection for the port's public entry points.

Entry points take ``device=`` and default to the card. There is no silent
fallback: asking for CUDA where none is available raises, and the plain
PyTorch path on the CPU runs only when the caller names it.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_with_mesh(device, mesh) -> torch.device:
    """An entry point's device under ``mesh=`` (parallel.mesh.Mesh): the
    mesh's device. A ``device=`` that names another device type or card
    raises ValueError. Without a mesh: resolve(device)."""
    if mesh is None:
        return resolve(device)
    if device is not None:
        want = torch.device(device)
        if want.type != mesh.device.type or (
            want.index is not None and mesh.device.index is not None and want.index != mesh.device.index
        ):
            raise ValueError(f"device={want} disagrees with the mesh's device {mesh.device}")
    return mesh.device


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises for any other
    device (a kernel wrapper either launches its kernel or takes the plain
    version, never a third path)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")
