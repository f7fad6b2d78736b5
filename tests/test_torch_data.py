"""The port's data pipeline against the reference's: the synthetic and
token-file streams give the reference's batches bit for bit (numpy on
both sides), the prefetching iterator yields them in order from any
``start_step`` (a restart resumes mid-stream), carries them to the device
as tensors, and stops its producer thread when closed."""
import threading

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLMStream as RefSynthetic
from repro.data.pipeline import TokenFileStream as RefTokenFile

import repro_torch.data as port_data
from repro_torch.data.pipeline import (DataConfig, SyntheticLMStream,
                                       TokenFileStream, make_batch_iterator,
                                       to_device)

CFGS = [dict(seq_len=16, global_batch=3, vocab=97, seed=5),
        dict(seq_len=8, global_batch=2, vocab=50, seed=0, memory_tokens=4,
             d_model=6)]


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


def test_exports():
    import repro.data as ref_data
    assert port_data.__all__ == ref_data.__all__


@pytest.mark.parametrize("kw", CFGS)
def test_synthetic_stream_bit_for_bit(kw):
    ref, port = RefSynthetic(RefDataConfig(**kw)), SyntheticLMStream(
        DataConfig(**kw))
    for step in (0, 1, 7, 1000):
        _equal(port.global_batch_at(step), ref.global_batch_at(step))


def test_token_file_stream_bit_for_bit(tmp_path):
    path = tmp_path / "corpus.bin"
    np.random.default_rng(1).integers(0, 1000, 5000).astype(np.int32) \
        .tofile(path)
    kw = dict(seq_len=32, global_batch=4, vocab=1000, seed=3)
    ref = RefTokenFile(RefDataConfig(**kw), str(path))
    port = TokenFileStream(DataConfig(**kw), str(path))
    for step in (0, 5, 99):
        _equal(port.global_batch_at(step), ref.global_batch_at(step))
    with pytest.raises(ValueError, match="shorter than one sequence"):
        TokenFileStream(DataConfig(seq_len=6000, global_batch=1, vocab=9),
                        str(path))


def _producers() -> int:
    return sum(1 for t in threading.enumerate()
               if t.daemon and t.name != "MainThread" and t.is_alive())


@pytest.mark.parametrize("start", [0, 3])
def test_iterator_resumes_from_start_step_and_closes(start):
    kw = CFGS[1]
    stream = SyntheticLMStream(DataConfig(**kw))
    ref = RefSynthetic(RefDataConfig(**kw))
    before = _producers()
    it = make_batch_iterator(stream, "cpu", start_step=start, prefetch=2)
    for step in range(start, start + 4):
        got = next(it)
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in got.values())
        _equal({k: v.numpy() for k, v in got.items()},
               ref.global_batch_at(step))
    it.close()
    assert _producers() == before


def test_to_device_keeps_dtypes_and_values():
    batch = SyntheticLMStream(DataConfig(**CFGS[1])).global_batch_at(2)
    got = to_device(batch, "cpu")
    assert got["tokens"].dtype == torch.int32
    assert got["memory"].dtype == torch.float32
    _equal({k: v.numpy() for k, v in got.items()}, batch)
