"""The reference's environment knobs that the port reads, each at import in
a fresh process as the reference reads it: HRT_SAMPLE_CHUNK and
HRT_RETIRE_DIV (integrator/wavefront.py), HRT_BVH_SAH (scene/bvh.py),
HRT_FORCE_STREAM (scene/build.py)."""
import os
import subprocess
import sys

import pytest

from _torch_parity import ROOT, TEAPOT


def _python(code, **env):
    full = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
                JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("chunk,div", [("", ""), ("2", "5")])
def test_wavefront_knobs_are_read_at_import(chunk, div):
    """HRT_SAMPLE_CHUNK and HRT_RETIRE_DIV in both packages (defaults 4
    and 12 when unset); a render with them set drains exactly, in chunks
    of the knob's size."""
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "from hobbyraytracer_tpu.integrator import wavefront as j\n"
        "from hobbyraytracer_tpu_torch.integrator import wavefront as p\n"
        "print('KNOBS', j.SAMPLE_CHUNK, p.SAMPLE_CHUNK, j.RETIRE_DIV, "
        "p.RETIRE_DIV)\n"
        "from hobbyraytracer_tpu_torch.core.rng import Sampler\n"
        "from hobbyraytracer_tpu_torch.scene import build_scene, "
        "load_scene_desc\n"
        f"job = build_scene(load_scene_desc({TEAPOT!r}))\n"
        "st = p.render_state(job.scene, job.camera, 6, 6, 5, "
        "Sampler(0, 'cpu'), max_depth=3, pool=64)\n"
        "print('DRAINED', int(st.retired), int(st.counter))\n")
    env = {}
    if chunk:
        env.update(HRT_SAMPLE_CHUNK=chunk, HRT_RETIRE_DIV=div)
    proc = _python(code, **env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    c, d = (int(chunk), int(div)) if chunk else (4, 12)
    assert f"KNOBS {c} {c} {d} {d}" in proc.stdout
    n_chunks = -(-5 // c)
    assert f"DRAINED {36 * 5} {36 * n_chunks}" in proc.stdout


def test_retire_div_validated():
    """HRT_RETIRE_DIV < 1 fails at import with the reference's message,
    not with a division by zero inside a segment."""
    proc = _python("import hobbyraytracer_tpu_torch.integrator.wavefront",
                   HRT_RETIRE_DIV="0")
    assert proc.returncode != 0
    assert "HRT_RETIRE_DIV" in proc.stderr and ">= 1" in proc.stderr


@pytest.mark.parametrize("sah", ["0", "1"])
def test_bvh_sah_knob_builds_the_reference_tables(sah):
    """HRT_BVH_SAH=0 (the median split) and =1 (the SAH split, the
    default): the teapot's cluster tables of the port's build_scene byte
    for byte those of a JAX build made under the same setting; the SAH
    build's digest is the one chip_smoke.py pins, the median build's is
    another."""
    code = (
        "import importlib.util\n"
        "import numpy as np\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "from hobbyraytracer_tpu.scene import build_scene as jb, "
        "load_scene_desc as jl\n"
        "from hobbyraytracer_tpu_torch.scene import build_scene as pb, "
        "load_scene_desc as pl\n"
        "from hobbyraytracer_tpu_torch.scene import bvh\n"
        f"mj = jb(jl({TEAPOT!r})).scene.instances[0].mesh\n"
        f"mp = pb(pl({TEAPOT!r})).scene.instances[0].mesh\n"
        "for f in ('cluster_id', 'cluster_bmin', 'cluster_bmax', 'tri_soa', "
        "'bounds8'):\n"
        "    a = getattr(mp, f).numpy(); b = np.asarray(getattr(mj, f))\n"
        "    assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f\n"
        "spec = importlib.util.spec_from_file_location('smoke', "
        "'chip_smoke.py')\n"
        "smoke = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(smoke)\n"
        "pinned = smoke.TABLE_SHA256['scenes/teapot_scene.yaml']\n"
        "print('SAH', bvh.BVH_SAH, smoke.table_digest(mp) == pinned)\n")
    proc = _python(code, HRT_BVH_SAH=sah)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"SAH {sah == '1'} {sah == '1'}" in proc.stdout


@pytest.mark.parametrize("force", ["0", "1"])
def test_force_stream_builds_the_reference_tables(force):
    """HRT_FORCE_STREAM=1 gives the teapot (K = 30, a 24-row resident table
    by default) the 32-row streaming table, as the reference's
    mesh_fits_vmem then says no to every mesh: the port's tables equal a
    JAX build made under the same setting byte for byte, and a refresh (a
    vertex fit's) keeps the layout."""
    code = (
        "import numpy as np\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "from hobbyraytracer_tpu.kernels import mesh_traverse as jk\n"
        "from hobbyraytracer_tpu.scene import build_scene as jb, "
        "load_scene_desc as jl\n"
        "from hobbyraytracer_tpu_torch.scene import build as pbuild, ir\n"
        "from hobbyraytracer_tpu_torch.scene import build_scene as pb, "
        "load_scene_desc as pl\n"
        f"mj = jb(jl({TEAPOT!r})).scene.instances[0].mesh\n"
        f"mp = pb(pl({TEAPOT!r})).scene.instances[0].mesh\n"
        "for f in ('cluster_id', 'tri_soa', 'bounds8'):\n"
        "    a = getattr(mp, f).numpy(); b = np.asarray(getattr(mj, f))\n"
        "    assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f\n"
        "rows = ir.refresh_kernel_tables(mp).tri_soa.shape[1]\n"
        "print('STREAM', jk.FORCE_STREAM, pbuild.FORCE_STREAM, "
        "mp.tri_soa.shape[1], rows)\n")
    proc = _python(code, HRT_FORCE_STREAM=force)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    on = force == "1"
    rows = 32 if on else 24
    assert f"STREAM {on} {on} {rows} {rows}" in proc.stdout
