"""Launch-layer tests: compile cache, farm card pinning, the cv2-free main
path, and chip_smoke.py's phases and exit rules, all on the CPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import chip_smoke
from vfp_tpu.parallel import farm
from vfp_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parent.parent


def _python(code: str, env_extra=None, cwd=None, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd or REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _write_clip(path, frames=18, h=64, w=96, fps=6):
    from vfp_tpu.io import RawVideoWriter

    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 2) % 256, (yy * 3) % 256, (xx + yy) % 256], -1)
    f = np.clip(base[None] + rng.randn(frames, h, w, 3) * 8, 0, 255).astype(np.uint8)
    with RawVideoWriter(path, w, h, fps=fps) as wr:
        wr.write_batch(f)


# -- compile cache ---------------------------------------------------------------

class TestCompileCache:
    def _spy(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
        return calls

    def test_env_var_honoured_and_nothing_set(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        calls = self._spy(monkeypatch)
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert calls == []

    def test_default_is_fixed_checkout_path(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        calls = self._spy(monkeypatch)
        first = compile_cache.enable_compile_cache()
        assert first == str(REPO / ".jax_cache") == compile_cache.enable_compile_cache()
        assert ("jax_compilation_cache_dir", first) in calls

    def test_cli_writes_cache_only_under_env_dir(self, tmp_path):
        _write_clip(tmp_path / "src.rawv")
        cache = tmp_path / "x"
        code = (
            "import sys, jax; sys.path.insert(0, %r)\n"
            "from vfp_tpu.cli.__main__ import main\n"
            "main(['--platform', 'cpu', 'mark', %r, %r, '--batch-size', '8'])\n"
            "print('CACHE', jax.config.jax_compilation_cache_dir)\n"
        ) % (str(REPO), str(tmp_path / "src.rawv"), str(tmp_path / "out.rawv"))
        r = _python(code, {"JAX_COMPILATION_CACHE_DIR": str(cache),
                           "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"})
        assert r.returncode == 0, r.stderr[-3000:]
        assert f"CACHE {cache}" in r.stdout
        assert any(cache.iterdir())


# -- farm ---------------------------------------------------------------------------

class TestFarmPinning:
    def test_one_card_per_worker(self):
        envs = farm.worker_envs(4, "cuda", ["0", "1", "2", "3"])
        assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "2", "3"]
        assert all(e["JAX_PLATFORMS"] == "cuda" for e in envs)
        envs = farm.worker_envs(2, "gpu", ["4", "6", "7"])
        assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["4", "6"]

    def test_more_workers_than_cards_is_an_error(self, monkeypatch, tmp_path):
        with pytest.raises(ValueError, match="one worker per card"):
            farm.worker_envs(5, "cuda", ["0", "1", "2", "3"])
        monkeypatch.setattr(farm, "parent_platform", lambda: "cuda")
        monkeypatch.setattr(farm, "visible_cards", lambda: ["0"])
        with pytest.raises(ValueError, match="one worker per card"):
            farm.mark_segments_parallel([tmp_path / "s.rawv"] * 2, tmp_path / "m",
                                        workers=2)

    def test_workers_inherit_a_cpu_parent(self, monkeypatch):
        assert farm.parent_platform() == "cpu"  # conftest pins the CPU
        envs = farm.worker_envs(3, "cpu", [])
        assert envs == [{"JAX_PLATFORMS": "cpu"}] * 3

    def test_visible_cards_from_env(self, monkeypatch):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2, 3")
        assert farm.visible_cards() == ["2", "3"]
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        assert farm.visible_cards() == []


# -- native library key ---------------------------------------------------------------

def test_native_library_keyed_by_source_and_flags(monkeypatch, tmp_path):
    """A library copied in with a checkout is reused only for the exact
    source and flags it was built from: the name carries their hash."""
    from vfp_tpu.native import build

    src = tmp_path / "vfpio.cpp"
    src.write_text("int x;\n")
    monkeypatch.setattr(build, "_SRC", src)
    first = build.library_path()
    assert first == build.library_path() and first.parent == build._BUILD
    src.write_text("int y;\n")
    second = build.library_path()
    assert second != first
    flags = build._compile_flags()
    monkeypatch.setattr(build, "_compile_flags", lambda: flags + ["-g"])
    assert build.library_path() not in (first, second)


# -- main path without optional packages -------------------------------------------

_NO_CV2 = (
    "import sys; sys.modules['cv2'] = None; sys.path.insert(0, %r)\n"
    "import jax; jax.config.update('jax_platforms', 'cpu')\n"
    "from vfp_tpu.cli.__main__ import main\n"
)


class TestWithoutCv2:
    def test_cli_mark_detect(self, tmp_path):
        _write_clip(tmp_path / "src.rawv")
        code = _NO_CV2 % str(REPO) + (
            "main(['mark', %r, %r, '--payload', '01100101', '--batch-size', '8'])\n"
            "main(['detect', %r, '--payload', '01100101', '--batch-size', '8'])\n"
        ) % (str(tmp_path / "src.rawv"), str(tmp_path / "m.rawv"),
             str(tmp_path / "m.rawv"))
        r = _python(code)
        assert r.returncode == 0, r.stderr[-3000:]
        assert "matches expected payload: True" in r.stdout

    def test_cli_hls_mark_leak_trace(self, tmp_path):
        _write_clip(tmp_path / "src.rawv")
        out = tmp_path / "out"
        code = _NO_CV2 % str(REPO) + (
            "main(['hls-mark', %r, %r, '--copies', '3', '--segment-duration', '1',"
            " '--batch-size', '8'])\n"
            "main(['leak', %r, '--pattern', '012', '--segment-duration', '1'])\n"
            "main(['trace', %r, %r, '--payload-file', %r, '--segment-duration', '1'])\n"
        ) % (str(tmp_path / "src.rawv"), str(out), str(out / "segment_copies.json"),
             str(out / "leaked_video.rawv"), str(tmp_path / "det"),
             str(out / "segment_payloads.json"))
        r = _python(code)
        assert r.returncode == 0, r.stderr[-3000:]
        assert "Copy fingerprint: 012" in r.stdout
        assert sorted(p.suffix for p in (out / "segments").iterdir()) == [".rawv"] * 3


# -- chip_smoke.py ------------------------------------------------------------------

class TestChipSmoke:
    def test_exits_nonzero_without_gpu(self):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                           env=dict(os.environ, JAX_PLATFORMS="cpu"),
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
        assert "no GPU" in r.stderr

    def test_four_exits_nonzero_without_cards(self):
        r = subprocess.run([sys.executable, "chip_smoke.py", "--four"], cwd=REPO,
                           env=dict(os.environ, JAX_PLATFORMS="cpu",
                                    CUDA_VISIBLE_DEVICES=""),
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0 and '"ok"' not in r.stdout

    def test_alone_exits_nonzero(self, tmp_path):
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=dict(os.environ, JAX_PLATFORMS="cpu"),
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0 and '"ok"' not in r.stdout

    @pytest.mark.parametrize("argv,phases,count", [
        ([], ["device", "codecs", "workflow"], 1),
        (["--four"], ["farm", "sharded"], 4),
    ])
    def test_option_selects_phases(self, monkeypatch, capsys, argv, phases, count):
        ran = []
        fake = [SimpleNamespace(platform="gpu", device_kind="Fake GPU")] * count
        for name in ("device", "codecs", "workflow", "farm", "sharded"):
            monkeypatch.setattr(chip_smoke, f"phase_{name}",
                                lambda *a, _n=name, **k: ran.append(_n))
        monkeypatch.setattr(chip_smoke, "_gpu_devices", lambda n: fake)
        monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: "Fake GPU, 700.00 W")
        monkeypatch.setattr(farm, "visible_cards", lambda: ["0", "1", "2", "3"])
        monkeypatch.setattr(jax, "devices", lambda *a: fake)
        chip_smoke.main(argv)
        assert ran == phases
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[-2] == "Fake GPU, 700.00 W"
        assert json.loads(lines[-1]) == {
            "ok": True, "device": {"platform": "gpu", "kind": "Fake GPU", "count": count}}

    def test_phase_device_on_cpu(self, capsys):
        chip_smoke.phase_device(jax.devices()[0], batch=2, h=64, w=96)
        assert "memory_analysis" in capsys.readouterr().out

    def test_phase_codecs_on_cpu(self):
        cpu = jax.devices("cpu")
        readings = chip_smoke.phase_codecs(cpu[0], cpu[1], batch=2, h=128, w=192,
                                           iters=1)
        assert set(readings) == {"DwtDctSvd", "DctQim", "DtcwtKey", "DtcwtImg"}
        assert all(r["mark_fps"] > 0 and r["extract_fps"] > 0 for r in readings.values())

    def test_phase_workflow_on_cpu(self, tmp_path):
        chip_smoke.phase_workflow(tmp_path, h=64, w=96, fps=6, seconds=3, segment=1,
                                  batch=8)

    def test_phase_sharded_on_cpu(self):
        chip_smoke.phase_sharded(jax.devices()[:4], batch=4, h=64, w=128)

    def test_phase_farm_on_cpu(self, tmp_path):
        chip_smoke.phase_farm(tmp_path, workers=2, h=64, w=96, fps=6, seconds=2,
                              segment=1, batch=8)

    @pytest.mark.gpu
    def test_phase_codecs_on_gpu(self, gpu_device):
        readings = chip_smoke.phase_codecs(gpu_device, jax.devices("cpu")[0],
                                           batch=2, h=128, w=192, iters=1)
        assert len(readings) == 4
