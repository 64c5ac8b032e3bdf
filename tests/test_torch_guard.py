"""The PyTorch port stands alone: no JAX, no Flax, nothing of tec_mollm_tpu."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "tec_mollm_tpu_torch"


def test_every_module_imports_with_jax_blocked():
    code = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax", "orbax", "tec_mollm_tpu"):
            sys.modules[name] = None  # any import of these now raises
        import tec_mollm_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(tec_mollm_tpu_torch.__path__, "tec_mollm_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / "chip_smoke.py")!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        leaked = [m for m in sys.modules if m.startswith("tec_mollm_tpu.")]
        assert not leaked, leaked
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20  # every module was reached


def test_no_source_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b|tec_mollm_tpu\.", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0)!r}" for f in files for m in pattern.finditer(f.read_text())]
    assert len(files) > 20
    assert not hits, hits


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a card it prints no result and exits non-zero, here and in a
    directory that holds chip_smoke.py alone."""
    import shutil

    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_profile_rows_count_kernels_once():
    """The busy share sums device rows only: host ops and user annotations on
    the device timeline (which span kernels already counted) are left out."""
    import importlib.util
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def event(key, ms, device, annotation=False):
        return SimpleNamespace(key=key, self_device_time_total=ms * 1e3, count=1,
                               device_type=device, is_user_annotation=annotation)

    rows = smoke.device_rows([
        event("aten::mm", 2.0, DeviceType.CPU),
        event("Optimizer.step#AdamW.step", 1.4, DeviceType.CUDA, annotation=True),
        event("multi_tensor_apply_kernel", 1.0, DeviceType.CUDA),
        event("flash_attention_kernel", 1.5, DeviceType.CUDA),
    ])
    assert rows == [(1.5, 1, "flash_attention_kernel"), (1.0, 1, "multi_tensor_apply_kernel")]
