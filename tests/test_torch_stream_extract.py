"""The port's stream extraction against metafast_tpu.ops.stream_extract.

Host layouts must equal the JAX builders (lane_multiple=1: the port pads
to whole 256-word columns only).  The plain PyTorch version must equal
the Pallas kernels run in interpret mode ELEMENTWISE, after the (hi, lo)
pairs are joined to int64 and the JAX [16, 256, C] planes are permuted
to the port's [16, C, 256].  The CUDA kernel itself is checked against
the plain version on the card in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metafast_tpu.ops import stream_extract as JSE
from metafast_tpu_torch.core.bitpack import SENTINEL
from metafast_tpu_torch.ops import stream_extract as TSE
from metafast_tpu_torch.state import join_pairs
from test_stream_extract import _oracle, _random_reads

KS = [1, 11, 16, 17, 31]
CPU = torch.device("cpu")


def _jax_keys(hi, lo):
    return join_pairs(np.asarray(hi), np.asarray(lo)).transpose(0, 2, 1)


@pytest.mark.parametrize("k", KS)
def test_stream3_matches_pallas_interpret(k):
    rng = np.random.default_rng(300 + k)
    codes, lengths = _random_reads(rng, k)
    host = TSE.build_stream3(codes, lengths, k)
    want_host = JSE.build_stream3(codes, lengths, k, lane_multiple=1)
    for a, b in zip(host, want_host[:4]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert host[0].shape[0] == TSE.stream3_cols(lengths, k)
    hi, lo = JSE.stream3_extract_pallas(*map(jnp.asarray, want_host[:4]), k,
                                        interpret=True)
    before = TSE.stream_extract.launches
    got = TSE.stream_extract(*TSE.to_device(
        (host[0], host[1], host[2], host[3]), CPU), k)
    assert got.dtype == torch.int64
    assert got.shape == (16, host[0].shape[0], TSE.ROWS)
    assert np.array_equal(got.numpy(), _jax_keys(hi, lo))
    assert TSE.stream_extract.launches == before
    live = got[got != SENTINEL].numpy()
    assert len(live) == want_host[4]
    assert np.array_equal(np.sort(live), _oracle(codes, lengths, k)
                          .astype(np.int64))


@pytest.mark.parametrize("k", KS)
def test_columns_matches_pallas_interpret(k):
    rng = np.random.default_rng(400 + k)
    codes, lengths = _random_reads(rng, k)
    words, vm = TSE.build_stream(codes, lengths, k)
    jw, jv, _ = JSE.build_stream(codes, lengths, k, lane_multiple=1)
    assert np.array_equal(words, jw) and np.array_equal(vm, jv)
    assert words.shape[0] == TSE.stream_cols(len(codes))
    hi, lo = JSE.stream_extract_pallas(jnp.asarray(jw), jnp.asarray(jv), k,
                                       interpret=True)
    tw, tv = TSE.to_device((words, vm), CPU)
    before = TSE.stream_extract.launches
    got = TSE.stream_extract(tw, None, None, tv, k, layout="columns")
    assert np.array_equal(got.numpy(), _jax_keys(hi, lo))
    assert TSE.stream_extract.launches == before


def test_wrapper_rejects_bad_inputs():
    w = torch.zeros((2, TSE.ROWS), dtype=torch.int32)
    with pytest.raises(ValueError):
        TSE.stream_extract(w, None, None, w, 31)            # missing w1, w2
    with pytest.raises(ValueError):
        TSE.stream_extract(w, w, w, w, 31, layout="columns")
    with pytest.raises(ValueError):
        TSE.stream_extract(w, w, w, w, 32)
    with pytest.raises(ValueError):
        TSE.stream_extract(w[:, :128], w[:, :128], w[:, :128], w[:, :128], 5)
    with pytest.raises(TypeError):
        TSE.stream_extract(w.long(), w.long(), w.long(), w.long(), 5)
