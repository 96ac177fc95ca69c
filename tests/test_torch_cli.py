"""The port's command line (python -m cutrace_tpu_torch) and its
jax-free guarantee."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from cutrace_tpu_torch import cli

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_usage_exit_code(capsys):
    """No scene argument: usage on stderr, exit 255 (the reference's -1)."""
    assert cli.main([]) == 255
    assert "Usage: cutrace_tpu_torch <scene file>" in capsys.readouterr().err


def test_bad_scene_dumps_schema(capsys, tmp_path):
    """An invalid scene: schema dump on stdout, exit 254 (the reference's
    -2)."""
    bad = tmp_path / "bad.json"
    bad.write_text('{"objects": [{"type": "nope"}]}')
    assert cli.main([str(bad), "--device", "cpu"]) == 254
    out = capsys.readouterr().out
    assert "Schema for scene files:" in out
    assert "type 'sphere'" in out


def test_cli_needs_the_card_or_cpu(tmp_path, monkeypatch, capsys):
    """Without a card and without --device cpu the CLI fails; it never
    carries on on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([str(REPO / "scenes" / "triangle.json"), "--out",
                     str(tmp_path)]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "frame.jpg").exists()


def test_render_outputs(tmp_path):
    """The happy path through the real process surface: scene dump,
    timing line and three 20x20 JPEGs."""
    from PIL import Image

    proc = subprocess.run(
        [sys.executable, "-m", "cutrace_tpu_torch", "scenes/triangle.json",
         "--out", str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert " -> Have 1    objects:" in proc.stdout
    assert "Render time was" in proc.stdout
    for name in ("frame.jpg", "depth_map.jpg", "normal_map.jpg"):
        assert Image.open(tmp_path / name).size == (20, 20), name


def test_width_height_override_like_jax(tmp_path):
    """--width/--height override the scene camera's resolution after
    loading: the port writes 32x18 JPEGs from the 20x20 triangle scene,
    as the JAX CLI does with the same flags."""
    from PIL import Image

    outs = {}
    for name, extra in (("cutrace_tpu_torch", ["--device", "cpu"]),
                        ("cutrace_tpu", ["--platform", "cpu"])):
        out = tmp_path / name
        proc = subprocess.run(
            [sys.executable, "-m", name, "scenes/triangle.json", "--out",
             str(out), "--width", "32", "--height", "18", "--bounces", "1",
             *extra],
            capture_output=True, text=True, cwd=REPO, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        outs[name] = {jpg: Image.open(out / jpg).size for jpg in (
            "frame.jpg", "depth_map.jpg", "normal_map.jpg")}
    assert outs["cutrace_tpu_torch"] == outs["cutrace_tpu"]
    assert set(outs["cutrace_tpu_torch"].values()) == {(32, 18)}


def test_strict_rejects_legacy_aliases_like_jax(capsys, tmp_path):
    """--strict loads without the legacy aliases ("model", "position"):
    bunny_small.json fails with the JAX CLI's exit code and schema dump;
    without it the scene still loads and renders."""
    from cutrace_tpu import cli as jcli

    scene = str(REPO / "scenes" / "bunny_small.json")
    rc = cli.main([scene, "--strict", "--device", "cpu", "--out",
                   str(tmp_path)])
    port = capsys.readouterr().out
    want_rc = jcli.main([scene, "--strict", "--out", str(tmp_path)])
    want = capsys.readouterr().out
    assert rc == want_rc == 254
    assert port == want and "Schema for scene files:" in port
    assert not (tmp_path / "frame.jpg").exists()
    assert cli.main([scene, "--device", "cpu", "--width", "8", "--height",
                     "8", "--bounces", "1", "--out", str(tmp_path)]) == 0
    assert (tmp_path / "frame.jpg").exists()


def test_port_never_loads_jax():
    """Importing the port (its parallel package too), rendering with it
    (fused, pallas, timed_render, and over a one-rank mesh) and taking one
    fit step on the CPU never loads jax or the JAX package
    (cutrace_tpu)."""
    code = (
        "import sys\n"
        "import cutrace_tpu_torch, cutrace_tpu_torch.perf_probe\n"
        "import cutrace_tpu_torch.cli, cutrace_tpu_torch.diff.checkpoint\n"
        "import cutrace_tpu_torch.bigscene, cutrace_tpu_torch.utils.profiling\n"
        "import cutrace_tpu_torch.ops.pallas_cast\n"
        "import cutrace_tpu_torch.parallel\n"
        "import cutrace_tpu_torch.parallel.multihost\n"
        "from cutrace_tpu_torch.render.renderer import prepare, render\n"
        "from cutrace_tpu_torch.parallel.train import fit\n"
        "sc = cutrace_tpu_torch.load_scene('scenes/triangle.json')\n"
        "sc.camera.width = sc.camera.height = 8\n"
        "c, d, n = render(prepare(sc, accel='pallas', device='cpu'), 2)\n"
        "p = prepare(sc, accel='fused', device='cpu')\n"
        "c, d, n = render(p, bounces=2)\n"
        "assert tuple(c.shape) == (8, 8, 3)\n"
        "from cutrace_tpu_torch.utils.profiling import timed_render\n"
        "(c, d, n), t = timed_render(p, bounces=2)\n"
        "assert 'Render time was' in str(t)\n"
        "from cutrace_tpu_torch.parallel import make_mesh, render_sharded\n"
        "c, d, n = render_sharded(p, make_mesh(1, 1, device='cpu'), 2)\n"
        "params, losses = fit(p.soa, c, steps=1, bounces=1, "
        "param_filter=('mat_color',), accel='fused', device='cpu')\n"
        "assert len(losses) == 1\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'cutrace_tpu'))\n"
        "print('LOADED', loaded)\n"
        "assert not loaded, loaded\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_example_never_loads_jax():
    """The inverse-rendering example runs on the CPU in a process that
    loads neither jax nor the JAX package (cutrace_tpu)."""
    code = (
        "import sys\n"
        "from cutrace_tpu_torch import inverse_rendering\n"
        "assert inverse_rendering.main(['--device', 'cpu', '--width', '8', "
        "'--height', '6', '--steps', '2'], camera_steps=2) == 0\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'cutrace_tpu'))\n"
        "print('LOADED', loaded)\n"
        "assert not loaded, loaded\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
    assert "eye error" in proc.stdout


def test_scaling_sweep_never_loads_jax():
    """The scaling sweep on the CPU (two gloo meshes in torchrun
    subprocesses, tiny) runs in a process that loads neither jax nor the
    JAX package; so do the fit-bits tool and the subprocess helpers."""
    code = (
        "import sys\n"
        "from cutrace_tpu_torch import compare_fits, scaling\n"
        "from cutrace_tpu_torch.utils import subprocs\n"
        "assert scaling.main(['--device', 'cpu', '--devices', '2', "
        "'--width', '8', '--height', '6', '--bounces', '1', "
        "'--reps', '1']) == 0\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'cutrace_tpu'))\n"
        "print('LOADED', loaded)\n"
        "assert not loaded, loaded\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
    assert '"metric": "scaling/bunny_8x6_b1/efficiency"' in proc.stdout


def test_perf_probe_needs_cuda(monkeypatch):
    """The frame-time probe refuses to run without a CUDA card."""
    from cutrace_tpu_torch import perf_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        perf_probe.main(["--scenes", "triangle.json"])


def test_no_jax_import_in_the_port():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.MULTILINE)
    files = sorted((REPO / "cutrace_tpu_torch").rglob("*.py"))
    assert len(files) >= 10
    for name in ("sharding.py", "multihost.py"):
        assert REPO / "cutrace_tpu_torch" / "parallel" / name in files
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders
    assert not pattern.search((REPO / "chip_smoke.py").read_text())
