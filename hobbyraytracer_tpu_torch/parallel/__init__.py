from .shard import (  # noqa: F401
    init_multihost, make_mesh, make_sharded_fit_step, render_sharded,
    render_wavefront_sharded, replicate_scene, shard_rays,
    sharded_fit_step, sharded_render_loss,
)
