"""The port stands without JAX, refuses to run without its device, and
never falls back from the CUDA kernel to its plain version."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from hobbyraytracer_tpu_torch.kernels import build as kbuild
from hobbyraytracer_tpu_torch.kernels import mesh_traverse as kmod

from _torch_parity import ROOT, TEAPOT

torch.set_num_threads(2)

PKG = pathlib.Path(ROOT) / "hobbyraytracer_tpu_torch"


def _run(code_or_args, cwd=ROOT, timeout=300):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_renders_on_cpu_without_importing_jax(tmp_path):
    out = tmp_path / "tiny.png"
    code = (
        "import sys\n"
        "from hobbyraytracer_tpu_torch.cli.main import main\n"
        f"rc = main(['render', {TEAPOT!r}, '-o', {str(out)!r}, '--spp', "
        "'2', '--width', '12', '--height', '10', '--pool', '64', "
        "'--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "loaded = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'hobbyraytracer_tpu.')))\n"
        "assert not loaded, loaded\n"
        "print('NO_JAX_OK')\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout
    assert "primary rays/s on cpu" in proc.stdout
    from hobbyraytracer_tpu.io.images import read_png
    assert read_png(str(out)).shape == (10, 12, 3)


def test_every_module_imports_without_jax():
    """Every module of the package (native/, the kernel wrappers, the
    codecs and the rest) imports with JAX and Pillow blocked, and pulls in
    neither (Pillow is imported only inside io/images.py:read_jpg, for the
    JPEG streams io/jpeg.py refuses)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import hobbyraytracer_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "loaded = sorted(m for m in sys.modules if m.startswith(("
        "'jax.', 'jaxlib', 'hobbyraytracer_tpu.', 'PIL.')))\n"
        "assert not loaded, loaded\n"
        "print('MODULES', len(names), ' '.join(names))\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    names = proc.stdout.split("MODULES", 1)[1].split()
    for mod in ("hobbyraytracer_tpu_torch.native",
                "hobbyraytracer_tpu_torch.kernels.mesh_traverse",
                "hobbyraytracer_tpu_torch.kernels.sphere_traverse",
                "hobbyraytracer_tpu_torch.kernels.build",
                "hobbyraytracer_tpu_torch.ops.intersect",
                "hobbyraytracer_tpu_torch.scene.ir",
                "hobbyraytracer_tpu_torch.scene.build",
                "hobbyraytracer_tpu_torch.scene.convert",
                "hobbyraytracer_tpu_torch.integrator.wavefront",
                "hobbyraytracer_tpu_torch.integrator.path",
                "hobbyraytracer_tpu_torch.core.rng",
                "hobbyraytracer_tpu_torch.diff.fit",
                "hobbyraytracer_tpu_torch.diff.edges",
                "hobbyraytracer_tpu_torch.diff.fd",
                "hobbyraytracer_tpu_torch.io.checkpoint",
                "hobbyraytracer_tpu_torch.parallel",
                "hobbyraytracer_tpu_torch.parallel.shard",
                "hobbyraytracer_tpu_torch.entry",
                "hobbyraytracer_tpu_torch.cli.main",
                "hobbyraytracer_tpu_torch.bench",
                "hobbyraytracer_tpu_torch.io.images",
                "hobbyraytracer_tpu_torch.io.jpeg",
                "hobbyraytracer_tpu_torch.io.extra_formats",
                "hobbyraytracer_tpu_torch.io.hdr",
                "hobbyraytracer_tpu_torch.scene.meshload",
                "hobbyraytracer_tpu_torch.scene.procgen",
                "hobbyraytracer_tpu_torch.scene.fixtures"):
        assert mod in names, (mod, names)
    assert int(names[0]) == len(list(PKG.rglob("*.py"))) - 1   # not itself


def test_package_sources_never_import_jax():
    """No import line of the package, of chip_smoke.py or of the port's
    scripts names JAX or the JAX package."""
    extra = [pathlib.Path(ROOT) / f for f in (
        "chip_smoke.py", "scripts/profile_port.py",
        "scripts/profile_fit.py", "scripts/time_mesh_kernels.py",
        "scripts/time_checkpoint.py")]
    for path in [*PKG.rglob("*.py"), *extra]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1]
                assert not (mod == "jax" or mod.startswith(("jax.", "jaxlib",
                            "hobbyraytracer_tpu."))
                            or mod == "hobbyraytracer_tpu"), (path, line)


def test_cli_batch_and_media_render_without_importing_jax(tmp_path):
    """The batch integrator on a scene with media, through the CLI on the
    CPU, in a process that never loads JAX."""
    out = tmp_path / "smoke.png"
    scene = os.path.join(ROOT, "scenes", "cornell_smoke.yaml")
    code = (
        "import sys\n"
        "from hobbyraytracer_tpu_torch.cli.main import main\n"
        f"rc = main(['render', {scene!r}, '-o', {str(out)!r}, '--spp', "
        "'2', '--width', '10', '--height', '8', '--max-depth', '4', "
        "'--integrator', 'batch', '--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "loaded = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'hobbyraytracer_tpu.')))\n"
        "assert not loaded, loaded\n"
        "print('NO_JAX_OK')\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout
    assert out.exists()


def test_cli_refuses_missing_device_and_unported_commands(capsys):
    """`render`, `fit` and `bench` (ported; its default device is cuda)
    refuse a CUDA device that is not there (rc 1) and never move to the
    CPU; no subcommand answers "not ported" any more."""
    from hobbyraytracer_tpu_torch import bench
    from hobbyraytracer_tpu_torch.cli import main as cli
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert cli.main(["render", TEAPOT, "--device", "cuda"]) == 1
    assert cli.main(["fit", TEAPOT, "--device", "cuda"]) == 1
    assert cli.main(["bench"]) == 1
    assert cli.main(["bench", "--device", "cuda:0"]) == 1
    assert bench.main([]) == 1
    out = capsys.readouterr().out
    assert out.count("CUDA is not available") == 5
    assert "not ported" not in out and "{" not in out
    assert not hasattr(cli, "_NOT_PORTED")


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    # alone in a directory, without the package
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_wrapper_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """A tensor off the CPU goes to the kernel; when the kernel cannot be
    built the wrapper raises, and the plain version is never called."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(kbuild, "find_nvcc", no_nvcc)
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kmod, "KERNEL", kbuild.KernelLibrary("mesh_traverse"))
    monkeypatch.setattr(kmod, "traverse_clusters_plain", plain)
    meta = dict(device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        kmod.traverse_clusters(
            torch.empty((256, 8), **meta), torch.empty((8, 30), **meta),
            torch.empty((30, 24, 128), **meta),
            torch.empty((30, 128), dtype=torch.int32, **meta))
    assert kmod.KERNEL.launches == 0


@pytest.mark.parametrize("switch", ["plain_versions", "eager"])
def test_comparison_switch_is_restored_after_a_raise(switch):
    """Each comparison switch of kernels/build.py holds inside its block
    (graphs off; under plain_versions the finds' wrappers pick their plain
    versions on a card, the draws' never) and is off again after a block
    that raises, an inner block of the same switch leaving it on."""
    cuda = torch.device("cuda")
    enter = getattr(kbuild, switch)
    assert kbuild.graphs_on(cuda) and not kbuild.runs_plain(cuda)
    with pytest.raises(RuntimeError, match="inside"):
        with enter():
            assert not kbuild.graphs_on(cuda)
            assert kbuild.runs_plain(cuda) == (switch == "plain_versions")
            assert not kbuild.runs_plain(cuda, find=False)
            with enter():
                pass
            assert not kbuild.graphs_on(cuda)
            raise RuntimeError("inside")
    assert kbuild.graphs_on(cuda) and not kbuild.runs_plain(cuda)
    assert kbuild.SWITCHES == {"plain": False, "eager": False}


def test_failed_build_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kbuild, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path / "build"))
    lib = kbuild.KernelLibrary("mesh_traverse")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        lib.load()
    assert not list((tmp_path / "build").iterdir())   # no half-built file


def test_stream_and_key_wrappers_raise_instead_of_falling_back(monkeypatch,
                                                               tmp_path):
    """K2 (a 32-row table) and K3 (coherence_keys, also through
    coherence_key in "pallas" mode) on tensors off the CPU: when the kernel
    cannot be built the wrapper raises, and no plain version runs."""
    from hobbyraytracer_tpu_torch.ops import intersect as pisect

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(kbuild, "find_nvcc", no_nvcc)
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path))
    for name in ("KERNEL", "KERNEL_STREAM", "KEY_KERNEL"):
        monkeypatch.setattr(kmod, name, kbuild.KernelLibrary(
            getattr(kmod, name).name))
    monkeypatch.setattr(kmod, "traverse_clusters_plain", plain)
    monkeypatch.setattr(kmod, "coherence_keys_plain", plain)
    meta = dict(device="meta")
    rays8 = torch.empty((256, 8), **meta)
    bounds8 = torch.empty((8, 822), **meta)
    with pytest.raises(RuntimeError, match="nvcc"):
        kmod.traverse_clusters(rays8, bounds8,
                               torch.empty((822, 32, 128), **meta), None)
    with pytest.raises(RuntimeError, match="nvcc"):
        kmod.coherence_keys(rays8, bounds8)
    monkeypatch.setattr(pisect, "KEY_MODE", "pallas")
    with pytest.raises(RuntimeError, match="nvcc"):
        pisect.coherence_key(rays8[:, :3], rays8[:, 3:6],
                             torch.ones((256,), dtype=torch.bool, **meta),
                             bounds8, 1e30)
    assert (kmod.KERNEL.launches, kmod.KERNEL_STREAM.launches,
            kmod.KEY_KERNEL.launches) == (0, 0, 0)


def test_sphere_wrapper_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """K4 on tensors off the CPU, called directly and through
    intersect_spheres_clustered and intersect_scene with SPHERE_KERNEL on:
    when the kernel cannot be built the wrapper raises; neither its plain
    version nor the dense scan takes over."""
    from hobbyraytracer_tpu_torch.core.types import Rays
    from hobbyraytracer_tpu_torch.kernels import sphere_traverse as skmod
    from hobbyraytracer_tpu_torch.ops import intersect as pisect
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
    from hobbyraytracer_tpu_torch.scene import ir as pir
    from _torch_parity import BALLS

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def other(*args, **kwargs):
        raise AssertionError("fell back from the kernel")

    monkeypatch.setattr(kbuild, "find_nvcc", no_nvcc)
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(skmod, "SPHERE_KERNEL",
                        kbuild.KernelLibrary("sphere_traverse"))
    monkeypatch.setattr(skmod, "intersect_spheres_plain", other)
    monkeypatch.setattr(pisect, "intersect_spheres", other)
    monkeypatch.setattr(pisect, "SPHERE_KERNEL", True)
    meta = dict(device="meta")
    rays8 = torch.empty((256, 8), **meta)
    tables = (torch.empty((8, 4), **meta), torch.empty((4, 8, 128), **meta),
              torch.empty((4, 128), dtype=torch.int32, **meta))
    with pytest.raises(RuntimeError, match="nvcc"):
        skmod.intersect_spheres_kernel(rays8, *tables, 1e-3)
    scene = build_scene(load_scene_desc(BALLS)).scene.to("meta")
    rays = Rays(o=rays8[:, 0:3], d=rays8[:, 3:6])
    with pytest.raises(RuntimeError, match="nvcc"):
        pir.intersect_scene(scene, rays)
    assert skmod.SPHERE_KERNEL.launches == 0


def test_sphere_scan_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """The dense sphere scan on tensors off the CPU, called directly and
    through intersect_spheres, intersect_scene (the default route) and a
    transformed sphere instance: when the sphere_scan kernel cannot be
    built the call raises; its plain version never takes over."""
    from hobbyraytracer_tpu_torch.core.types import Rays
    from hobbyraytracer_tpu_torch.kernels import sphere_scan as scmod
    from hobbyraytracer_tpu_torch.ops import intersect as pisect
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
    from hobbyraytracer_tpu_torch.scene import ir as pir
    from _torch_parity import BALLS

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def other(*args, **kwargs):
        raise AssertionError("fell back from the kernel")

    monkeypatch.setattr(kbuild, "find_nvcc", no_nvcc)
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(scmod, "SCAN_KERNEL",
                        kbuild.KernelLibrary("sphere_scan"))
    monkeypatch.setattr(scmod, "scan_spheres_plain", other)
    scene = build_scene(load_scene_desc(BALLS)).scene.to("meta")
    sp = scene.spheres
    rays = Rays(o=torch.empty((256, 3), device="meta"),
                d=torch.empty((256, 3), device="meta"))
    with pytest.raises(RuntimeError, match="nvcc"):
        scmod.scan_spheres(rays, sp.center, sp.radius, 1e-3, 1e30)
    with pytest.raises(RuntimeError, match="nvcc"):
        pisect.intersect_spheres(rays, sp.center, sp.radius, sp.mat_id, 1e-3,
                                 1e30)
    assert pir.sphere_route(scene) == "dense"
    with pytest.raises(RuntimeError, match="nvcc"):
        pir.intersect_scene(scene, rays)
    inst = pir.Instance("sphere", spheres=sp)
    with pytest.raises(RuntimeError, match="nvcc"):
        pir._intersect_instance(inst, rays, 1e-3)
    assert scmod.SCAN_KERNEL.launches == 0


def test_mesh_find_never_moves_to_the_lockstep_find(monkeypatch, tmp_path):
    """A mesh scene on tensors off the CPU, through intersect_scene (by
    the "kernel" and the fit's "kernel_replay" backend), a wavefront
    segment with the pool sort on, and the fit's differentiable
    integrator: when K1 cannot be built the call raises; neither the plain
    version nor the lockstep find (which serves the explicit "lockstep"
    backend and the mesh-boundary media only) takes over."""
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.core.types import Rays
    from hobbyraytracer_tpu_torch.integrator import wavefront as pwf
    from hobbyraytracer_tpu_torch.ops import intersect as pisect
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
    from hobbyraytracer_tpu_torch.scene import ir as pir

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def other(*args, **kwargs):
        raise AssertionError("fell back from the kernel")

    monkeypatch.setattr(kbuild, "find_nvcc", no_nvcc)
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kmod, "KERNEL", kbuild.KernelLibrary("mesh_traverse"))
    monkeypatch.setattr(kmod, "traverse_clusters_plain", other)
    monkeypatch.setattr(pisect, "intersect_mesh_clustered", other)
    monkeypatch.setattr(pisect, "intersect_triangles", other)
    job = build_scene(load_scene_desc(
        os.path.join(ROOT, "scenes", "two_teapots.yaml")))
    scene = job.scene.to("meta")
    rays = Rays(o=torch.empty((64, 3), device="meta"),
                d=torch.empty((64, 3), device="meta"))
    for backend in ("kernel", "kernel_replay"):
        for cohsort in (None, False):
            with pytest.raises(RuntimeError, match="nvcc"):
                pir.intersect_scene(scene, rays, mesh_cohsort=cohsort,
                                    mesh_backend=backend)
    state = pwf.init_state(8, 8, 64, "meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        pwf._segment(state, scene, 8, 8, Sampler(0, "meta"), 50, 1,
                     pool_sort=1)
    from hobbyraytracer_tpu_torch.integrator import path as ppath
    with pytest.raises(RuntimeError, match="nvcc"):
        ppath.trace_diff(scene, rays, Sampler(0, "meta"), 2)
    assert kmod.KERNEL.launches == 0


def test_import_starts_no_process_group_and_no_cuda():
    """Importing every module of the package (parallel/ among them)
    initialises no torch.distributed process group and no CUDA context."""
    code = (
        "import importlib, pkgutil\n"
        "import torch, torch.distributed as dist\n"
        "import hobbyraytracer_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('STATE', dist.is_initialized(), torch.cuda.is_initialized())\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "STATE False False" in proc.stdout


def test_sharded_paths_raise_instead_of_falling_back(monkeypatch, tmp_path):
    """The sharded wavefront render and fit loss of a mesh scene on two
    workers off the CPU: when K1 cannot be built each raises; neither its
    plain version nor the lockstep find takes over."""
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.diff import fit as pfit
    from hobbyraytracer_tpu_torch.ops import intersect as pisect
    from hobbyraytracer_tpu_torch.parallel import shard
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def other(*args, **kwargs):
        raise AssertionError("fell back from the kernel")

    monkeypatch.setattr(kbuild, "find_nvcc", no_nvcc)
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kmod, "KERNEL", kbuild.KernelLibrary("mesh_traverse"))
    monkeypatch.setattr(kmod, "traverse_clusters_plain", other)
    monkeypatch.setattr(pisect, "intersect_mesh_clustered", other)
    class MetaSampler(Sampler):
        """Draws of the right shapes on the meta device (no generator
        runs there)."""

        def _draw(self, key, shape, span, floats):
            return torch.empty(tuple(shape), device=self.device,
                               dtype=torch.float32 if floats else torch.int64)

        def fold_in(self, index):
            return MetaSampler(index, self.device)

    job = build_scene(load_scene_desc(TEAPOT))
    mesh = ["meta", "meta"]
    scene, camera = job.scene.to("meta"), job.camera.to("meta")
    sampler = MetaSampler(0, "meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        shard.render_wavefront_sharded(scene, camera, 8, 8, 1, sampler, mesh,
                                       pool=64)
    params, rebuild = pfit.select_params(scene)
    target = torch.empty((64, 3), device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        shard.sharded_render_loss(params, rebuild, camera, 8, 8, sampler, 1,
                                  target, mesh)
    assert kmod.KERNEL.launches == 0
