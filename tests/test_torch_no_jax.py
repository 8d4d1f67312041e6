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


def test_package_sources_never_import_jax():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1]
                assert not (mod == "jax" or mod.startswith(("jax.", "jaxlib",
                            "hobbyraytracer_tpu."))
                            or mod == "hobbyraytracer_tpu"), (path, line)


def test_cli_refuses_missing_device_and_unported_commands():
    from hobbyraytracer_tpu_torch.cli import main as cli
    if not torch.cuda.is_available():
        assert cli.main(["render", TEAPOT, "--device", "cuda"]) == 1
    assert cli.main(["fit"]) == 2
    assert cli.main(["bench"]) == 2


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
