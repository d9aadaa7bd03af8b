"""Disk-memoized oracle renders: the golden fixtures SURVEY.md §4 prescribed.

The scalar float64 oracle is deliberately slow (~ms per pixel-bounce); the
parity suite re-rendering the same frames on every run dominated wall time.
`cached_render` memoizes `cpu_oracle.render`
to `tests/golden/<sha>.npy`, keyed by a hash of

  - the oracle module source itself (any oracle change invalidates all
    fixtures automatically), and
  - every input: scene state, resolution, uniforms, quirk flags.

Delete `tests/golden/` to force full regeneration. Fixtures are committed
so CI runs the parity gate in seconds while the oracle remains the single
source of truth for what the golden values are.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os

import numpy as np

from pathtracer_tpu.oracle import cpu_oracle as O

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

_ORACLE_SRC_HASH = hashlib.sha256(
    inspect.getsource(O).encode()
).hexdigest()


def _fingerprint_value(h, val):
    """Feed an arbitrary oracle-scene attribute into the hash."""
    if isinstance(val, np.ndarray):
        h.update(val.tobytes())
        h.update(str(val.shape).encode())
    elif isinstance(val, (list, tuple)):
        for x in val:
            _fingerprint_value(h, x)
    elif isinstance(val, dict):
        for k in sorted(val):
            h.update(str(k).encode())
            _fingerprint_value(h, val[k])
    elif isinstance(val, (int, float, bool, str)):
        h.update(json.dumps(val).encode())
    else:
        # pytrees (e.g. the Material table): flatten to arrays + structure
        import jax

        leaves, treedef = jax.tree_util.tree_flatten(val)
        h.update(str(treedef).encode())
        for leaf in leaves:
            _fingerprint_value(h, np.asarray(leaf))


def cached_render(scene: O.OracleScene, width, height, cam_u, bounce_u, **flags):
    """cpu_oracle.render memoized to tests/golden/. Same signature/result."""
    h = hashlib.sha256()
    h.update(_ORACLE_SRC_HASH.encode())
    h.update(json.dumps([width, height], sort_keys=True).encode())
    h.update(json.dumps(sorted(flags.items())).encode())
    _fingerprint_value(h, np.asarray(cam_u, np.float64))
    _fingerprint_value(h, np.asarray(bounce_u, np.float64))
    for k in sorted(vars(scene)):
        h.update(k.encode())
        _fingerprint_value(h, vars(scene)[k])

    path = os.path.join(GOLDEN_DIR, h.hexdigest()[:24] + ".npy")
    if os.path.exists(path):
        return np.load(path)
    img = O.render(scene, width, height, cam_u, bounce_u, **flags)
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        np.save(fh, img)
    os.replace(tmp, path)
    return img
