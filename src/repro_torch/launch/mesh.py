"""The production meshes of the dry run.

The JAX package compiles its dry run on 512 virtual host devices. The port
has no compiler to feed, so its meshes are ``VirtualMesh``es on the meta
device: named axes with sizes, nothing allocated and no device touched,
here or when the module is imported.
"""

from __future__ import annotations

from repro_torch.sharding.mesh import VirtualMesh
from repro_torch.sharding.mesh import make_mesh as _make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> VirtualMesh:
    """16x16 = 256 chips per pod over (``data``, ``model``); multi-pod adds
    a leading 2-pod axis (512 chips)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, "meta")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> VirtualMesh:
    return _make_mesh(shape, axes, "meta")
