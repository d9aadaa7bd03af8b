"""Inverse rendering: pixel-loss gradients to scene parameters.

The capability the reference cannot have (its materials are code,
analytical.rs:56-85): here every scene quantity — material table, light
emission/position, sphere geometry, checker albedos, sky, camera — is a
pytree leaf, and the integrator is differentiable end-to-end via the
detached-sampling estimator (ops/bsdf.disney_sample) with per-bounce
rematerialization. BASELINE config 4 ("recover material albedo/roughness +
light intensity from a target image") is `recover_demo` below.

Parameter selection is by key-path substring: `select=("materials.rgb",
"lights.emission")` optimizes exactly those leaves, leaving the rest
frozen (and never differentiating integer leaves).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Iterable, NamedTuple

import jax
import jax.numpy as jnp

from ..models.scene import Scene
from .tracer import VERBATIM, Quirks, render_frame


def keypath_str(path) -> str:
    """'materials.rgb.x'-style dotted name for a tree_util key path."""
    parts = []
    for k in path:
        if hasattr(k, "name"):
            parts.append(str(k.name))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        elif hasattr(k, "key"):
            parts.append(str(k.key))
        else:
            parts.append(str(k))
    return ".".join(parts)


def select_leaves(tree, select: Iterable[str]):
    """Split `tree` into (trainable leaf list, rebuild fn) where a leaf is
    trainable iff any pattern in `select` is a substring of its dotted
    key path and the leaf is inexact (float)."""
    patterns = tuple(select)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    idxs, train = [], []
    for i, (path, leaf) in enumerate(flat):
        name = keypath_str(path)
        if any(p in name for p in patterns) and jnp.issubdtype(
            jnp.asarray(leaf).dtype, jnp.inexact
        ):
            idxs.append(i)
            train.append(leaf)
    if not idxs:
        raise ValueError(f"no trainable leaves matched {patterns}")
    leaves = [leaf for _, leaf in flat]

    def rebuild(train_vals):
        out = list(leaves)
        for j, i in enumerate(idxs):
            out[i] = train_vals[j]
        return jax.tree_util.tree_unflatten(treedef, out)

    names = [keypath_str(flat[i][0]) for i in idxs]
    return train, rebuild, names


def image_loss(img, target):
    """Mean squared error on RGB (alpha is constant 1)."""
    return jnp.mean((img[..., :3] - target[..., :3]) ** 2)


def paired_image_loss(img_a, img_b, target):
    """Unbiased surrogate for the MSE of the *expected* image.

    With a Monte-Carlo renderer, E[mse(I, t)] = ||E[I]-t||^2 + Var(I):
    minimizing the naive single-sample MSE is biased toward low-variance
    (darker) parameters — e.g. light emission systematically under-recovers
    because brightness scales path variance. The classic remedy is two
    independent renders I_a, I_b of the same scene:

        E[(I_a - t) · (I_b - t)] = ||E[I] - t||^2        (exactly)

    so the cross product drops the variance term. The gradient flows
    through I_a only (I_b is stop-gradient), giving an unbiased estimate
    of ∇||E[I] - t||^2 up to the usual detached-sampling caveats.
    """
    a = img_a[..., :3] - target[..., :3]
    b = jax.lax.stop_gradient(img_b[..., :3] - target[..., :3])
    return jnp.mean(a * b)


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "quirks"),
)
def render_loss(
    scene: Scene,
    target,
    key,
    width: int,
    height: int,
    spp: int = 4,
    quirks: Quirks = VERBATIM,
):
    """Differentiable render + MSE against a target image."""
    img = render_frame(
        scene, key, width, height, spp=spp, quirks=quirks, detach=True, remat=True
    )
    return image_loss(img, target)


class OptResult(NamedTuple):
    scene: Scene
    losses: jnp.ndarray  # [steps]


def inverse_render(
    scene: Scene,
    target,
    key,
    select: Iterable[str],
    width: int,
    height: int,
    steps: int = 100,
    lr: float = 2e-2,
    spp: int = 4,
    quirks: Quirks = VERBATIM,
    optimizer=None,
    param_transform: Callable | None = None,
    crn: bool = True,
    unbiased: bool = True,
    verbose: bool = False,
    kernel: str = "xla",
    tile_rows: int | None = None,
    interpret: bool = False,
) -> OptResult:
    """Adam-optimize the selected scene leaves against a target image.

    unbiased=True (default) uses the two-render paired loss
    (`paired_image_loss`): twice the forward cost per step, but the
    optimum is the true expected-image MSE minimum — the naive
    single-sample MSE is systematically biased toward low-variance
    (darker/smoother) parameters. crn=True (common random numbers)
    reuses one fixed key (pair) every step: the surrogate loss becomes
    deterministic in the parameters, which removes the Monte-Carlo noise
    floor from the descent at the cost of a small surrogate bias.
    crn=False draws fresh keys per step (unbiased stochastic gradient).
    param_transform, if given, maps the rebuilt scene before rendering
    (e.g. clamping to valid ranges).

    kernel="pallas" runs both renders through the fused GPU kernel; its
    custom VJP is the XLA integrator's VJP on the kernel's own samples.
    Limit: scenes a kernel backend claims. tile_rows and interpret (the
    Pallas interpreter, CPU only) apply to the kernel. Media presence is
    detected from the concrete input scene here (inside the jitted step
    the leaves are tracers and render_frame_pallas's own auto-detection
    cannot see them).
    """
    import optax

    train, rebuild, names = select_leaves(scene, select)
    if verbose:
        print("optimizing:", names)
    opt = optimizer if optimizer is not None else optax.adam(lr)
    opt_state = opt.init(train)

    @partial(jax.jit, static_argnames=())
    def step(train, opt_state, k):
        def loss_fn(tv):
            s = rebuild(tv)
            if param_transform is not None:
                s = param_transform(s)

            def render(kk):
                if kernel == "pallas":
                    from ..ops.megakernel import _detect_media, render_frame_pallas

                    return render_frame_pallas(
                        s, kk, width, height, spp=spp, quirks=quirks,
                        tile_rows=tile_rows, media=_detect_media(scene),
                        interpret=interpret,
                    )
                return render_frame(
                    s, kk, width, height, spp=spp, quirks=quirks,
                    detach=True, remat=True,
                )

            if unbiased:
                ka, kb = jax.random.split(k)
                return paired_image_loss(render(ka), render(kb), target)
            return image_loss(render(k), target)

        loss, grads = jax.value_and_grad(loss_fn)(train)
        updates, opt_state = opt.update(grads, opt_state, train)
        train = optax.apply_updates(train, updates)
        return train, opt_state, loss

    losses = []
    for i in range(steps):
        if crn:
            sub = key
        else:
            key, sub = jax.random.split(key)
        train, opt_state, loss = step(train, opt_state, sub)
        losses.append(loss)
        if verbose and (i % 10 == 0 or i == steps - 1):
            print(f"step {i:4d}  loss {float(loss):.6e}")

    final = rebuild(train)
    if param_transform is not None:
        final = param_transform(final)
    return OptResult(scene=final, losses=jnp.stack(losses))


class RecoverRow(NamedTuple):
    """One parameter's recovery record in a RecoverReport."""

    name: str
    true_value: float
    start_value: float
    recovered: float
    rel_err: float


class RecoverReport(NamedTuple):
    rows: list  # [RecoverRow]
    losses: jnp.ndarray  # [steps]
    scene: Scene  # recovered scene


def recover_demo(
    key=None,
    width: int = 256,
    height: int = 192,
    steps: int = 80,
    spp: int = 1,
    lr: float = 3e-2,
    select: Iterable[str] | None = None,
    scene: str = "analytical",
    kernel: str = "auto",
    mesh=None,
    tile_rows: int | None = None,
    ckpt_dir: str | None = None,
    ckpt_every: int = 20,
    recursion_depth: int = 4,
    interpret: bool = False,
    verbose: bool = True,
) -> RecoverReport:
    """BASELINE config 4, end to end: recover material albedo, roughness,
    and light emission from a target render of the analytical demo scene —
    the inverse of the reference's dormant scriptable-materials intent
    (materials as data, /root/reference/rust-pathtracer/src/material.rs:77;
    its tracer never invokes the hook, and Rust code could not be
    differentiated if it did).

    scene="analytical" recovers material albedo/roughness + light
    emission; scene="sdf" recovers GEOMETRY — sphere radius and torus
    major radius of the sphere-traced SDF scene — through the
    implicit-function hit-distance gradients (models/sdf.sphere_trace's
    Newton reattachment), plus the light. `select=None` picks the
    per-family default.

    Pipeline: render the target with the TRUE parameters, perturb the
    selected leaves, then Adam-descend the common-random-number paired
    loss (`paired_image_loss` — unbiased in the expected image) through
    the chosen render path:

    - kernel="pallas", mesh=None: the fused GPU kernel, whose custom VJP
      is the XLA integrator's VJP on the kernel's own samples;
    - kernel="pallas", mesh=a jax.sharding.Mesh: the SHARDED kernel
      (parallel/mesh.render_frame_sharded_pallas) — per-device backward
      rules, psum'd cotangents;
    - kernel="xla": the lax.scan integrator with per-bounce remat;
    - kernel="auto": XLA, which measured faster than the kernel for
      differentiated renders (the kernel has no backward kernel yet).
    interpret=True runs the kernel in the Pallas interpreter on the CPU.

    Optimizer state is checkpointed every `ckpt_every` steps to `ckpt_dir`
    (atomic npz, utils/checkpoint) and the demo resumes from the latest
    checkpoint if one exists. Returns a RecoverReport: per-parameter
    (true, start, recovered, rel err) rows + the loss curve. CLI:
    `python app/invert.py`.

    Reading the report: the plane material's rgb (index 2, the reference's
    1.5 default) is overridden per-ray by the procedural checker
    (analytical.rs:107-115), so it is UNIDENTIFIABLE from renders and
    parks at the clamp boundary; likewise the matte plane's roughness is
    only weakly identifiable. The physically visible parameters (sphere
    albedos, sphere roughness, light emission) are the ones expected to
    recover to a few percent.
    """
    import optax

    from ..models.analytical import make_scene as make_analytical_scene
    from ..utils.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )

    if key is None:
        key = jax.random.PRNGKey(0)

    if scene == "sdf":
        from ..models.sdf import make_scene as make_sdf_scene

        true_scene = make_sdf_scene(
            dtype=jnp.float32, recursion_depth=recursion_depth
        )
        if select is None:
            select = (
                "sphere_radius", "torus_major", "lights.emission",
            )
    else:
        true_scene = make_analytical_scene(
            dtype=jnp.float32, recursion_depth=recursion_depth
        )
        if select is None:
            select = (
                "materials.rgb", "materials.roughness", "lights.emission",
            )

    def make_render(kind):
        if kind not in ("auto", "pallas", "xla"):
            raise ValueError(
                f"kernel must be 'auto'|'pallas'|'xla', got {kind!r}"
            )
        # "auto" is XLA here: the kernel's backward rule is the XLA VJP,
        # so kernel forward + XLA backward measured slower than XLA alone
        # (fwd+bwd cell, PERF.md Findings).
        if mesh is not None and kind != "pallas":
            raise ValueError("mesh= shards the kernel: pass kernel='pallas'")
        if kind == "pallas" and mesh is not None:
            from ..parallel.mesh import render_frame_sharded_pallas

            return lambda s, k: render_frame_sharded_pallas(
                s, k, mesh, width, height, spp=spp, tile_rows=tile_rows,
                interpret=interpret, media=False,
            )
        if kind == "pallas":
            from ..ops.megakernel import render_frame_pallas

            return lambda s, k: render_frame_pallas(
                s, k, width, height, spp=spp, tile_rows=tile_rows,
                interpret=interpret, media=False,
            )
        return lambda s, k: render_frame(
            s, k, width, height, spp=spp, detach=True, remat=True
        )

    render = make_render(kernel)

    # Target: a few accumulated true-parameter frames (lower MC noise in
    # the target costs nothing at optimization time).
    tkeys = jax.random.split(jax.random.fold_in(key, 17), 4)
    target = sum(render(true_scene, k) for k in tkeys) / 4.0
    target = jax.lax.stop_gradient(target)

    if scene == "sdf":
        # Perturbed start: geometry shrunk/grown, light dimmed.
        p0 = true_scene.params
        start_scene = true_scene.replace(
            params=p0._replace(
                sphere_radius=p0.sphere_radius * 0.75,
                torus_major=p0.torus_major * 1.25,
            ),
            lights=true_scene.lights._replace(
                emission=true_scene.lights.emission * 0.45
            ),
        )

        def projection(s_):
            p_ = s_.params
            s_ = s_.replace(params=p_._replace(
                sphere_radius=jnp.maximum(p_.sphere_radius, 0.05),
                torus_major=jnp.maximum(p_.torus_major, 0.05),
            ))
            return s_.replace(lights=s_.lights._replace(
                emission=s_.lights.emission.max_f(0.0)
            ))
    else:
        # Perturbed start: albedo shifted, roughness flattened, light dimmed.
        m = true_scene.params.materials
        start_scene = true_scene.replace(
            params=true_scene.params._replace(
                materials=m._replace(
                    rgb=m.rgb * 0.55 + 0.25,
                    roughness=jnp.clip(m.roughness * 0.3 + 0.35, 0.001, 1.0),
                )
            ),
            lights=true_scene.lights._replace(
                emission=true_scene.lights.emission * 0.45
            ),
        )
        projection = clamp_material_params

    train, rebuild, names = select_leaves(start_scene, select)
    true_train, _, _ = select_leaves(true_scene, select)
    start_train = [jnp.asarray(x) for x in train]
    opt = optax.adam(lr)
    opt_state = opt.init(train)

    @jax.jit
    def step_fn(train, opt_state, k):
        def loss_fn(tv):
            s = projection(rebuild(tv))
            ka, kb = jax.random.split(k)
            return paired_image_loss(render(s, ka), render(s, kb), target)

        loss, grads = jax.value_and_grad(loss_fn)(train)
        updates, opt_state = opt.update(grads, opt_state, train)
        train = optax.apply_updates(train, updates)
        return train, opt_state, loss

    start_step = 0
    if ckpt_dir is not None:
        path = latest_checkpoint(ckpt_dir, prefix="invert_")
        if path is not None:
            train, opt_state, s0 = load_checkpoint(
                path, (train, opt_state, jnp.zeros((), jnp.int32))
            )
            start_step = int(s0)
            if verbose:
                print(f"resumed from {path} at step {start_step}")

    # CRN pairing requires the same key WITHIN a step (target and render
    # share it), not across steps: fold the step index in so Adam sees a
    # fresh Monte-Carlo realization each step (unbiased over the run) while
    # checkpoint/resume stays deterministic via the step counter.
    kbase = jax.random.fold_in(key, 29)
    losses = []
    for i in range(start_step, steps):
        train, opt_state, loss = step_fn(
            train, opt_state, jax.random.fold_in(kbase, i)
        )
        losses.append(loss)
        if verbose and (i % 10 == 0 or i == steps - 1):
            print(f"step {i:4d}  loss {float(loss):.6e}")
        if ckpt_dir is not None and ((i + 1) % ckpt_every == 0 or i == steps - 1):
            import os

            os.makedirs(ckpt_dir, exist_ok=True)
            save_checkpoint(
                os.path.join(ckpt_dir, f"invert_{i + 1:06d}.npz"),
                (train, opt_state, jnp.asarray(i + 1, jnp.int32)),
            )

    final_scene = projection(rebuild(train))
    final_train, _, _ = select_leaves(final_scene, select)

    import numpy as _np

    rows = []
    for name, tv, sv, rv in zip(names, true_train, start_train, final_train):
        tv, sv, rv = _np.ravel(tv), _np.ravel(sv), _np.ravel(rv)
        for j in range(tv.size):
            t, s0v, r = float(tv[j]), float(sv[j]), float(rv[j])
            rel = abs(r - t) / max(abs(t), 1e-3)
            rows.append(RecoverRow(f"{name}[{j}]", t, s0v, r, rel))

    if verbose:
        print(f"{'parameter':28s} {'true':>8s} {'start':>8s} "
              f"{'recovered':>10s} {'rel err':>8s}")
        for r in rows:
            print(f"{r.name:28s} {r.true_value:8.4f} {r.start_value:8.4f} "
                  f"{r.recovered:10.4f} {r.rel_err:8.3f}")
        med = sorted(r.rel_err for r in rows)[len(rows) // 2]
        print(f"median rel err: {med:.3f}")

    return RecoverReport(
        rows=rows,
        losses=jnp.stack(losses) if losses else jnp.zeros((0,)),
        scene=final_scene,
    )


def clamp_material_params(scene: Scene) -> Scene:
    """Projection keeping optimized materials/lights physically plausible."""
    p = scene.params
    if hasattr(p, "materials"):
        m = p.materials
        m = m._replace(
            rgb=m.rgb.clip(0.0, 1.0),
            roughness=jnp.clip(m.roughness, 0.001, 1.0),
            metallic=jnp.clip(m.metallic, 0.0, 1.0),
            clearcoat=jnp.clip(m.clearcoat, 0.0, 1.0),
            spec_trans=jnp.clip(m.spec_trans, 0.0, 1.0),
        )
        p = p._replace(materials=m)
        scene = scene.replace(params=p)
    lights = scene.lights
    lights = lights._replace(
        emission=lights.emission.max_f(0.0), radius=jnp.maximum(lights.radius, 1e-3)
    )
    return scene.replace(lights=lights)
