"""One device path: backend resolution, the compile-cache rule, the native
library's rebuild rule, and the chip smoke test's device helpers."""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest

from ebcc_tpu import EBCCConfig, api
from ebcc_tpu.runtime import native
from ebcc_tpu.utils import compile_cache, device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_auto_backend_is_the_device(direction):
    """"auto" runs the device pipeline everywhere; only an explicit "cpu"
    selects the native codec."""
    use_cpu = (api._use_cpu_encode if direction == "encode"
               else api._use_cpu_decode)
    assert use_cpu(EBCCConfig()) is False
    assert use_cpu(EBCCConfig(**{f"{direction}_backend": "device"})) is False
    assert use_cpu(EBCCConfig(**{f"{direction}_backend": "cpu"})) is True


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "no-env"])
def test_compile_cache_dir_rule(monkeypatch, tmp_path, env_set):
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    else:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    used = compile_cache.enable_compile_cache()
    if env_set:
        # JAX reads the variable itself; no code sets another directory
        assert used == str(tmp_path)
        assert "jax_compilation_cache_dir" not in updates
    else:
        assert used == updates["jax_compilation_cache_dir"]
        assert used == os.path.join(ROOT, ".jax_cache")


@pytest.fixture
def fake_native(monkeypatch, tmp_path):
    """native.py pointed at a scratch directory whose Makefile records
    each build and "links" an empty library."""
    (tmp_path / "Makefile").write_text(
        "all:\n\ttouch libebcc_host.so\n\techo built >> builds.log\n"
        "clean:\n\trm -f libebcc_host.so\n")
    (tmp_path / "a.cc").write_text("// source\n")
    monkeypatch.setattr(native, "_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB_PATH",
                        str(tmp_path / "libebcc_host.so"))
    monkeypatch.setattr(native, "_STAMP_PATH",
                        str(tmp_path / "libebcc_host.stamp"))
    assert native.build()
    assert not native.is_stale()
    return tmp_path


def _builds(d):
    return (d / "builds.log").read_text().count("built")


@pytest.mark.parametrize("cause", ["missing", "newer-source", "other-host"])
def test_stale_native_library_is_rebuilt(fake_native, cause):
    lib = fake_native / "libebcc_host.so"
    if cause == "missing":
        lib.unlink()
    elif cause == "newer-source":
        t = os.path.getmtime(fake_native / "a.cc") - 10
        os.utime(lib, (t, t))
    else:
        (fake_native / "libebcc_host.stamp").write_text("another-host")
    assert native.is_stale()
    assert native.build()
    assert _builds(fake_native) == 2
    assert not native.is_stale()
    assert (fake_native / "libebcc_host.stamp").read_text() == \
        native.host_id()


def test_chip_smoke_refuses_cpu(capsys):
    cs = _chip_smoke()
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="needs a GPU"):
        device.require_gpu()


def test_result_line_format():
    info = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = device.result_line(info)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": info}


def test_parse_nvidia_smi_line():
    assert device.parse_nvidia_smi("NVIDIA H100 80GB HBM3, 700.00 W") == \
        ("NVIDIA H100 80GB HBM3", 700.0)
    with pytest.raises(ValueError):
        device.parse_nvidia_smi("NVIDIA H100 80GB HBM3, [N/A]")


@pytest.mark.gpu
def test_device_blob_decodes_within_bound_on_both_decoders(gpu):
    """On the card: the device encode's blob holds the bound through the
    device recon and through the native decoder HDF5 readers use."""
    import ebcc_tpu
    from ebcc_tpu.dataprep import synthetic_frames
    data = synthetic_frames(4, 96, 160, sigma=0.3)
    cfg = EBCCConfig(error=0.5, max_batch=4, encode_backend="device")
    blob = ebcc_tpu.compress(data, cfg)
    for backend in ("device", "cpu"):
        rec = ebcc_tpu.decompress(
            blob, EBCCConfig(error=0.5, max_batch=4, decode_backend=backend))
        assert float(np.abs(rec - data).max()) <= 0.5
