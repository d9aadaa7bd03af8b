"""pathtracer_tpu: a differentiable path tracer for NVIDIA GPUs (JAX/XLA/Pallas).

Brand-new framework with the capabilities of markusmoenig/rust-pathtracer
(reference mounted at /root/reference): progressive Monte-Carlo integration
with NEE + MIS and a four-lobe Disney/principled BSDF over pluggable scene
backends — rebuilt for accelerators: SoA vector math, masked wavefront
bounce loops under lax.scan, a fused Pallas-Triton path kernel, counter-based reproducible RNG, pixel/spp
sharding over device meshes, and end-to-end differentiability to material,
light, camera, and SDF parameters.

This module is the `prelude` (reference: rust-pathtracer/src/lib.rs:24-48):
one flat namespace re-exporting the public API.
"""

from .integrator.tracer import (
    EPS,
    FIXED,
    U_PER_BOUNCE,
    VERBATIM,
    LightSample,
    PathState,
    Quirks,
    accumulate,
    direct_light,
    draw_uniforms,
    render_frame,
    sample_light,
    sample_light_distant,
    sample_light_rect,
    sample_light_spherical,
    measure_occupancy,
    sample_lights_emitter,
    trace,
)
from .integrator.inverse import (
    RecoverReport,
    RecoverRow,
    inverse_render,
    recover_demo,
    render_loss,
)
from .ops.megakernel import (
    KernelBackend,
    measure_occupancy_pallas,
    register_backend,
    render_frame_pallas,
    resolve_tiling,
)
from .models.analytical import (
    AnalyticalParams,
    default_params as analytical_default_params,
    make_scene as make_analytical_scene,
)
from .models.camera import Pinhole, default_pinhole, gen_ray, pixel_coords
from .models.mesh import (
    MeshParams,
    default_params as mesh_default_params,
    make_scene as make_mesh_scene,
)
from .models.sdf import (
    SdfParams,
    default_params as sdf_default_params,
    make_scene as make_sdf_scene,
    scene_sdf,
    sdf_normal,
    sphere_trace,
)
from .models.light import (
    Lights,
    LightType,
    concat_lights,
    distant_light,
    gather_light,
    rect_light,
    spherical_light,
)
from .models.material import (
    AlphaMode,
    Material,
    Medium,
    MediumType,
    default_material,
    default_medium,
    finalize_material,
    gather_material,
    make_material,
    mix_materials,
    select_material,
    stack_materials,
)
from .models.ray import Ray, make_ray
from .models.scene import Scene, SurfaceHit
from .ops import bsdf, intersect, sampling, vecmath
from .ops.vecmath import (
    INV_PI,
    PI,
    TWO_PI,
    B3,
    V2,
    V3,
    less_than,
    cross,
    dot,
    from_array,
    hex_color,
    length,
    luminance,
    mix,
    mix_f,
    normalize,
    onb,
    ones3,
    pow3,
    reflect,
    refract,
    safe_normalize,
    smoothstep,
    splat3,
    to_local,
    to_world,
    v3,
    where3,
    zeros3,
)

__version__ = "0.1.0"
