"""The port stands alone: neither src/repro_torch nor chip_smoke.py
imports JAX or the JAX package, and the kernel dispatch never launches
(or counts) a kernel for CPU tensors."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(mod: str) -> bool:
    return mod.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _run(code, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args] if not code else
                          [sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_importing_the_port_loads_no_jax():
    """tests/conftest.py imports jax in this process, so the check runs
    in a fresh interpreter."""
    res = _run("import sys, repro_torch.serve.engine, "
               "repro_torch.serve.graphs, repro_torch.serve.request, "
               "repro_torch.serve.scheduler, "
               "repro_torch.launch.serve, repro_torch.bridge, "
               "repro_torch.launch.train, repro_torch.checkpoint; "
               "bad = [m for m in sys.modules "
               "if m.split('.')[0] in ('jax', 'repro')]; "
               "print(bad); assert not bad")
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the chip smoke exits non-zero and prints no result
    line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    res = _run(None, "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_cpu_tensors_count_no_kernel_launches():
    from repro_torch.kernels import ops

    ops.reset_launches()
    rng = np.random.RandomState(0)
    f = lambda *s: torch.as_tensor(rng.randn(*s).astype(np.float32))
    pos = torch.zeros((1, 1, 8), dtype=torch.int32)
    ops.decode_attention(f(1, 2, 16), f(1, 1, 8, 16), f(1, 1, 8, 16), pos, 9)
    cache = {"k": f(1, 1, 8, 16), "v": f(1, 1, 8, 16), "pos": pos}
    ops.chunk_attention(f(1, 4, 2, 16), f(1, 4, 1, 16), f(1, 4, 1, 16),
                        cache, torch.arange(4, dtype=torch.int32) + 9)
    ops.retention_attention(f(1, 4, 2, 16), f(1, 4, 1, 16), f(1, 4, 1, 16))
    lb = (-f(1, 40, 2).abs()).requires_grad_(True)
    ops.capacity_loss_log(lb, 4).backward()
    ops.capacity_loss(f(1, 40, 2).sigmoid(), 4)
    assert ops.LAUNCHES == dict.fromkeys(ops.KERNELS, 0)
    assert set(ops.KERNELS) >= {"capacity_loss", "capacity_loss_bwd"}


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on the
    CPU itself."""
    from repro_torch.kernels.capacity_loss import (capacity_loss_bwd_cuda,
                                                   capacity_loss_fwd_cuda)
    from repro_torch.kernels.retention_attention import \
        retention_attention_cuda

    x = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        retention_attention_cuda(x, x[:, :, :1].contiguous(),
                                 x[:, :, :1].contiguous())
    lb = torch.zeros((1, 40, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        capacity_loss_fwd_cuda(lb, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        capacity_loss_bwd_cuda(torch.zeros((2, 40)), torch.zeros((2, 40)), 4,
                               torch.ones(()), 2)


def test_entry_points_refuse_without_a_card():
    """Entry points default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import train_loop

    cfg = get_smoke_config("trimkv-paper-4b")
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        train_loop(cfg, TrainConfig(), DataConfig(), steps=1)
