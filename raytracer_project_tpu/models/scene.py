"""Scene container + builder: the differentiable scene pytree.

Replaces the reference's mutable shared_ptr world (hittable_list.hpp,
scene_management.hpp) with an immutable pytree of SoA arrays. Because the
scene is a pytree of jnp leaves, it IS the parameter vector for inverse
rendering — gradients w.r.t. sphere centers, material albedos, sun
direction, etc. fall out of jax.grad directly.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax

from .environment import Environment, make_environment
from .geometry import BoxTable, GeometryBuilder, SphereTable, TriangleTable
from .materials import MaterialLibrary, MaterialTable
from .textures import TextureBank, TextureBankBuilder


class Scene(NamedTuple):
    """Frozen device-ready scene (a pytree)."""

    spheres: SphereTable
    triangles: TriangleTable
    materials: MaterialTable
    textures: TextureBank
    bvh: Any = None      # ops.bvh.FlatBVH once built; None = brute force
    volumes: Any = None  # ops.volumes.VolumeTable; None = no media
    boxes: BoxTable | None = None  # native affine-slab boxes (cube.hpp)

    @property
    def primitive_count(self) -> int:
        n = self.spheres.count + self.triangles.count
        if self.boxes is not None:
            n += self.boxes.count
        return n


class SceneBuilder:
    """Host-side scene assembly mirroring scene_management.hpp workflows.

    Usage:
        b = SceneBuilder()
        red = b.materials.lambertian("red", (0.8, 0.1, 0.1))
        b.geometry.add_sphere((0, 1, 0), 1.0, red)
        scene = b.build()
    """

    def __init__(self):
        self.geometry = GeometryBuilder()
        self.materials = MaterialLibrary()
        self.textures = TextureBankBuilder()
        self._volumes: list[dict] = []

    def add_fog_sphere(self, center, radius, density, color,
                       texture_id: int = -1, name: str | None = None) -> None:
        """Spherical constant-density medium
        (constant_medium.hpp ctor, scene_management.hpp:228-234)."""
        mat = self.materials.isotropic(
            name or f"__fog_{len(self._volumes)}__", tuple(color), texture_id
        )
        self._volumes.append(dict(kind=0, center=tuple(center),
                                  radius=float(radius),
                                  box_min=(0, 0, 0), box_max=(0, 0, 0),
                                  density=float(density), mat=mat))

    def add_fog_box(self, box_min, box_max, density, color,
                    texture_id: int = -1, name: str | None = None) -> None:
        """Axis-aligned-box constant-density medium."""
        mat = self.materials.isotropic(
            name or f"__fog_{len(self._volumes)}__", tuple(color), texture_id
        )
        self._volumes.append(dict(kind=1, center=(0, 0, 0), radius=0.0,
                                  box_min=tuple(box_min),
                                  box_max=tuple(box_max),
                                  density=float(density), mat=mat))

    def _pack_volumes(self):
        if not self._volumes:
            return None
        import numpy as np

        from ..ops.volumes import VolumeTable

        vs = self._volumes
        mats = np.asarray([v["mat"] for v in vs], np.int32)
        return VolumeTable(
            kind=np.asarray([v["kind"] for v in vs], np.int32),
            center=np.asarray([v["center"] for v in vs], np.float32),
            radius=np.asarray([v["radius"] for v in vs], np.float32),
            box_min=np.asarray([v["box_min"] for v in vs], np.float32),
            box_max=np.asarray([v["box_max"] for v in vs], np.float32),
            neg_inv_density=np.asarray(
                [-1.0 / v["density"] for v in vs], np.float32
            ),
            mat=mats,
        )

    def build(self, with_bvh: bool = True) -> Scene:
        """Assemble entirely in numpy (host), then convert the whole pytree
        to device arrays in one pass — small mixed numpy/jnp ops during
        building would each trigger a device compile."""
        import jax
        import jax.numpy as jnp

        spheres, triangles, boxes = self.geometry.pack()
        scene = Scene(
            spheres=spheres,
            triangles=triangles,
            boxes=boxes,
            materials=self.materials.pack(),
            textures=self.textures.pack(),
            bvh=None,
            volumes=self._pack_volumes(),
        )
        if with_bvh:
            from ..ops import bvh as bvh_mod

            scene = scene._replace(bvh=bvh_mod.build_bvh(scene, as_numpy=True))
        return jax.tree.map(jnp.asarray, scene)
