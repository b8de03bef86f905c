"""The port's CUDA kernel on the card: held against its plain version.

Imports torch and the port only, so it runs on a machine with a card and
no JAX:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
Without a card every test skips (the fixture decides, at run time).
Tolerances: f32 1e-5 (both sides sum in f32, in different orders); bf16
2e-2 (the output's single bf16 rounding can land on either side).
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_ref,
)

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(b, s, kvh, rep, hd, lens, dtype, device, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, kvh * rep, hd, generator=gen)
    k = torch.randn(b, s, kvh, hd, generator=gen)
    v = torch.randn(b, s, kvh, hd, generator=gen)
    return (q.to(device, dtype), k.to(device, dtype), v.to(device, dtype),
            torch.tensor(lens, dtype=torch.int32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rep", [1, 4, 7, 8])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_kernel_matches_plain_version(cuda_device, dtype, rep, hd):
    s = 203                     # no multiple of any tile
    lens = [1, s, 37, 128, 129, 64]
    args = _inputs(len(lens), s, 2, rep, hd, lens, dtype, cuda_device)
    before = decode_attention.launches
    got = decode_attention(*args)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(),
                               decode_attention_ref(*args).float(),
                               **TOL[dtype])


@pytest.mark.cuda
def test_kernel_rows_do_not_depend_on_the_batch(cuda_device):
    """No atomics, order fixed by kv_len: a row alone equals the same row
    inside a batch, bit for bit."""
    lens = [300, 5, 1024, 77]
    q, k, v, kv = _inputs(4, 1024, 8, 4, 128, lens, torch.bfloat16,
                          cuda_device)
    full = decode_attention(q, k, v, kv)
    for b in range(4):
        one = decode_attention(q[b:b + 1].contiguous(),
                               k[b:b + 1].contiguous(),
                               v[b:b + 1].contiguous(), kv[b:b + 1])
        assert torch.equal(one[0], full[b])


@pytest.mark.cuda
def test_engine_decode_runs_the_kernel(cuda_device):
    """Slotted decode on the card launches the kernel once per layer."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.registry import build_model
    cfg = reduced_config("qwen3-4b")
    bundle = build_model(cfg)
    params = bundle.init(0, device=cuda_device)
    cache = bundle.make_slot_cache(2, 32, device=cuda_device)
    cache["lens"] += torch.tensor([3, 9], dtype=torch.int32,
                                  device=cuda_device)
    before = decode_attention.launches
    logits, cache = bundle.decode_slotted(params, cache, {
        "tokens": torch.tensor([[1], [2]], dtype=torch.int32,
                               device=cuda_device),
        "active": torch.tensor([True, True], device=cuda_device)})
    torch.cuda.synchronize()
    assert decode_attention.launches == before + cfg.n_layers
    assert torch.isfinite(logits).all()
    assert cache["lens"].tolist() == [4, 10]
