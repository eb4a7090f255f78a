"""The f32 resident serving conv (K1, ``fused_sparse_conv``) on the tensor
cores through 3xTF32, from the CPU:

- its arithmetic, the 3xTF32 gather-GEMM of ``gather_mma.cuh`` (modelled
  by ``ops.cuda.sparse_conv_train.gather_gemm_tf32``) then bias, ReLU and
  zero where no tap of the row hits, against the JAX package's K1
  reference (``sessd_tpu.ops.sparse.sparse_conv_apply`` with the same
  epilogue, the plain conv its tests hold ``_fused_kernel`` to) within
  1e-5 of max|reference|, with and without the ReLU, on the conv shapes of
  ``tests/test_torch_tf32_split.py``;
- bit for bit the model of f32 K3 that
  ``tests/test_torch_tf32_dw.py::test_k3_f32_model_with_epilogue_against_jax``
  holds to JAX, and bit for bit the f32 forward's model plus the epilogue:
  the sources give f32 K1 the same ``gather_mma_tile`` instance as f32 K3
  (the EPI store, no cluster split), and the f32 forward the same tile
  with the masked store, so on the card f32 K1 == f32 K3 == K4 + the
  epilogue;
- the C entry's launch of that instance: one CTA per tile (the split rule
  and the at-split entry are bf16's), and ``conv_instance`` names it.

The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py
holds it against its twin, its scalar entry, K3 and the forward).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.ops.sparse import sparse_conv_apply
from sessd_torch.ops.cuda import sparse_conv as sc
from sessd_torch.ops.cuda import sparse_conv_train as kt
from tests.test_torch_tf32_split import (CSRC, IDS, N_IN, N_OUT, TF32_CONVS,
                                         _inputs, _rel)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

K1_BOUND = 1e-5  # the model against JAX's plain conv (it keeps ~21 bits)


def _epilogue(acc, bias, hit, relu):
    out = acc + bias
    if relu:
        out = torch.relu(out)
    return torch.where(hit, out, 0.0)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("cin,cout,k", TF32_CONVS, ids=IDS)
def test_k1_f32_model_with_epilogue_against_jax(cin, cout, k, relu):
    feats, rb, w2, _ = _inputs(cin, cout, k)
    bias = (np.random.RandomState(k).randn(cout) * 0.3).astype(np.float32)
    assert sc.conv_instance("fused_sparse_conv", torch.float32, cin,
                            cout) == "tf32"
    conv = np.array(sparse_conv_apply(jnp.asarray(feats), jnp.asarray(rb),
                                      jnp.asarray(w2),
                                      jnp.ones(N_OUT, bool)))
    hit = (rb != N_IN).any(1, keepdims=True)
    want = conv + bias
    want = np.where(hit, np.maximum(want, 0.0) if relu else want, 0.0)
    t = torch.from_numpy
    acc = kt.gather_gemm_tf32(t(feats), t(rb), t(w2))
    model = _epilogue(acc, t(bias), t(hit), relu)
    assert _rel(model.numpy(), want) <= K1_BOUND
    twin = sc.fused_sparse_conv_ref(t(feats), t(rb), t(w2), t(bias), N_IN,
                                    relu)
    assert _rel(model.numpy(), twin.numpy()) <= K1_BOUND
    assert not model[~t(hit)[:, 0]].any()
    # K3's model (test_torch_tf32_dw.py), and the forward's model with the
    # epilogue: the same bits
    k3 = torch.where(t(hit), torch.relu(acc + t(bias)), 0.0) if relu \
        else torch.where(t(hit), acc + t(bias), 0.0)
    assert torch.equal(model, k3)
    fwd = torch.where(torch.ones(N_OUT, 1, dtype=torch.bool), acc, 0.0)
    assert torch.equal(model, _epilogue(fwd, t(bias), t(hit), relu))


def _kernel_body(path, kernel):
    text = (CSRC / path).read_text()
    body = text[text.index(kernel + "("):]
    return body[:body.index("\n}\n")]


def test_k1_k3_and_k4_take_one_f32_instance():
    """In f32 at 16-64 channels K1 calls ``gather_mma_tile`` with the
    arguments K3 calls it with (EPI store, no cluster split), and K4 with
    the masked store; K1's f32 launch is one CTA per tile of the tile's
    threads and shared memory, and the C split entry answers 1 for it."""
    tf32 = "sessd::kTf32Tile<T, CIN, COUT>"
    k1 = _kernel_body("sparse_conv.cu", "fused_sparse_conv_kernel")
    k3 = _kernel_body("sparse_conv_stream.cu",
                      "fused_sparse_conv_stream_kernel")
    k4 = _kernel_body("sparse_conv_train.cu", "sparse_conv_fwd_kernel")
    call = "sessd::gather_mma_tile<IdxT, CIN, COUT, true>("
    k1_f32 = k1[k1.index(f"else if constexpr ({tf32})"):]
    k1_f32 = k1_f32[:k1_f32.index("else\n")]
    assert call in k1_f32 and call in k3 and tf32 in k3
    assert "sessd::gather_mma_tile<IdxT, CIN, COUT, false>(" in k4
    assert tf32 in k4
    src = (CSRC / "sparse_conv.cu").read_text()
    launch = src[src.index("} else if constexpr (sessd::kTf32Tile<T, CIN, "
                           "COUT>) {"):]
    launch = launch[:launch.index("} else {")]
    assert "if (split > 1) return cudaErrorInvalidValue;" in launch
    assert "kern<<<tiles, sessd::kMmaThreads, sessd::kTileSmemBytes<T, " \
        "CIN, COUT>," in launch
    split = src[src.index('extern "C" int sessd_fused_sparse_conv_split('):]
    assert "if (inst != 2 || n_out <= 0) return 1;" in split
    at_split = src[src.index('extern "C" int '
                             'sessd_fused_sparse_conv_at_split('):]
    at_split = at_split[:at_split.index("\n}\n")]
    assert "fused_instance<__nv_bfloat16>(cin, cout) != 2" in at_split
    assert "dtype != 1" in at_split
