"""Scene description files: JSON <-> Scene pytree.

The reference planned a scripting surface for scene content (rhai
registration, /root/reference/rust-pathtracer/src/fx.rs:124-166 — dormant)
so a non-code user could describe materials and geometry. The JAX-native
equivalent of "scene as data" is literally the scene PYTREE: every
differentiable quantity (sphere centers, materials, lights, camera, sky)
is a leaf array, addressed by its tree path. This module serializes those
leaves to JSON and loads them back over a family's default scene — a
text-file scene description with zero schema code per family.

Format:

    {
      "family": "analytical" | "sdf" | "mesh" | "bigmesh",
      "recursion_depth": 4,
      "params":  {".sphere_radius": [0.5, 0.5], ...},
      "lights":  {".emission.x": [3.0], ...},
      "camera":  {".origin.z": 5.0, ...}
    }

Keys are jax.tree_util.keystr paths into the family's params / lights /
camera pytrees; any leaf may be omitted (the family default is kept) and
unknown keys are an error (catches typos). STATIC structure — mesh
topology, light count, material count — comes from the family defaults:
this is a parameter file, not a geometry interchange format.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

from ..models.scene import Scene

FAMILIES = ("analytical", "sdf", "mesh", "bigmesh")


def _default_scene(family: str, dtype, recursion_depth: int) -> Scene:
    if family == "analytical":
        from ..models.analytical import make_scene
    elif family == "sdf":
        from ..models.sdf import make_scene
    elif family == "mesh":
        from ..models.mesh import make_scene
    elif family == "bigmesh":
        from ..models.bigmesh import make_scene
    else:
        raise ValueError(f"unknown scene family {family!r}; one of {FAMILIES}")
    return make_scene(dtype=dtype, recursion_depth=recursion_depth)


def _leaves_to_dict(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        out[jax.tree_util.keystr(path)] = (
            a.item() if a.ndim == 0 else a.tolist()
        )
    return out


def _dict_into_tree(tree, overrides: dict, section: str):
    """Replace leaves of `tree` named in `overrides` (by keystr path)."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(tree)
    known = {jax.tree_util.keystr(p): i for i, (p, _) in enumerate(paths)}
    unknown = set(overrides) - set(known)
    if unknown:
        raise KeyError(
            f"unknown {section} leaf path(s) {sorted(unknown)}; "
            f"known: {sorted(known)}"
        )
    leaves = [leaf for _, leaf in paths]
    for key, val in overrides.items():
        i = known[key]
        ref = leaves[i]
        arr = jnp.asarray(val, dtype=ref.dtype)
        if arr.shape != jnp.shape(ref):
            raise ValueError(
                f"{section} leaf {key}: shape {arr.shape} != "
                f"expected {jnp.shape(ref)}"
            )
        leaves[i] = arr
    return jax.tree_util.tree_unflatten(treedef, leaves)


def scene_to_dict(scene: Scene, family: str) -> dict:
    """Serialize a scene's differentiable leaves (params/lights/camera)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown scene family {family!r}")
    return {
        "family": family,
        "recursion_depth": int(scene.recursion_depth),
        "params": _leaves_to_dict(scene.params),
        "lights": _leaves_to_dict(scene.lights),
        "camera": _leaves_to_dict(scene.camera),
    }


def save_scene(scene: Scene, path: str, family: str) -> None:
    with open(path, "w") as f:
        json.dump(scene_to_dict(scene, family), f, indent=1)


def scene_from_dict(desc: dict, dtype=jnp.float32,
                    recursion_depth: int | None = None) -> Scene:
    """Build a Scene: the family's default pytree with the description's
    leaves written over it. recursion_depth (CLI --depth) overrides the
    file's value when given."""
    family = desc.get("family", "analytical")
    depth = (recursion_depth if recursion_depth is not None
             else int(desc.get("recursion_depth", 4)))
    scene = _default_scene(family, dtype, depth)
    scene = scene.replace(
        params=_dict_into_tree(scene.params, desc.get("params", {}), "params"),
        lights=_dict_into_tree(scene.lights, desc.get("lights", {}), "lights"),
        camera=_dict_into_tree(scene.camera, desc.get("camera", {}), "camera"),
    )
    return scene


def load_scene(path: str, dtype=jnp.float32,
               recursion_depth: int | None = None) -> Scene:
    with open(path) as f:
        return scene_from_dict(json.load(f), dtype, recursion_depth)
