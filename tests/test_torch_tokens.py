"""The port's TokenPipeline (repro_torch.data.tokens) against repro's.

repro's three cases (tests/test_checkpoint.py) on the port, and every
batch bit-equal to repro's for the same seed, chunk and shape.  The
port's batches are int32 tensors on the CPU here (`device="cpu"`).
"""

import numpy as np
import pytest
import torch

from repro.data import TokenPipeline as JTokenPipeline
from repro_torch.data import TokenPipeline


def test_token_pipeline_serves_all_chunks_once(tmp_path):
    pipe = TokenPipeline(vocab=100, batch=2, seq_len=8, n_chunks=6,
                         batches_per_chunk=2,
                         journal_path=str(tmp_path / "tp.json"),
                         device="cpu")
    seen = []
    for cid, batch in pipe:
        assert batch["tokens"].shape == (2, 8)
        assert batch["tokens"].dtype == torch.int32
        assert batch["tokens"].device.type == "cpu"
        assert batch["labels"][0, -1] == -1
        seen.append(cid)
    assert sorted(set(seen)) == list(range(6))
    assert len(seen) == 12  # 6 chunks x 2 batches, no duplicates (no faults)


def test_token_pipeline_resumes_after_crash(tmp_path):
    path = str(tmp_path / "tp.json")
    pipe = TokenPipeline(vocab=100, batch=2, seq_len=8, n_chunks=4,
                         batches_per_chunk=1, journal_path=path,
                         device="cpu")
    it = iter(pipe)
    first = [next(it)[0], next(it)[0]]          # 2 chunks served, done
    del it, pipe                                 # "crash"
    pipe2 = TokenPipeline(vocab=100, batch=2, seq_len=8, n_chunks=4,
                          batches_per_chunk=1, journal_path=path,
                          device="cpu")
    rest = [cid for cid, _ in pipe2]
    # every chunk served at least once; chunks not marked done before the
    # crash are re-served (at-least-once: the traversing property)
    assert sorted(set(first + rest)) == [0, 1, 2, 3]
    assert set(rest) >= {2, 3}


def test_token_pipeline_deterministic_chunks():
    a = TokenPipeline(vocab=50, batch=1, seq_len=4, n_chunks=2,
                      batches_per_chunk=1, seed=3, device="cpu")
    b = TokenPipeline(vocab=50, batch=1, seq_len=4, n_chunks=2,
                      batches_per_chunk=1, seed=3, device="cpu")
    ba = {c: x["tokens"].tolist() for c, x in a}
    bb = {c: x["tokens"].tolist() for c, x in b}
    assert ba == bb


@pytest.mark.parametrize("seed,vocab,batch,seq_len", [(0, 100, 2, 8),
                                                      (3, 50, 1, 4),
                                                      (7, 32000, 4, 129)])
def test_batches_bit_equal_to_repro(seed, vocab, batch, seq_len):
    kw = dict(vocab=vocab, batch=batch, seq_len=seq_len, n_chunks=5,
              batches_per_chunk=3, seed=seed)
    got = list(TokenPipeline(device="cpu", **kw))
    want = list(JTokenPipeline(**kw))
    assert [c for c, _ in got] == [c for c, _ in want]
    for (_, g), (_, w) in zip(got, want):
        for key in ("tokens", "labels"):
            assert g[key].dtype == torch.int32
            np.testing.assert_array_equal(g[key].numpy(), w[key])
            assert g[key].numpy().tobytes() == w[key].tobytes()


def test_a_crashed_worker_is_helped_to_every_chunk(tmp_path):
    """Worker 0 takes chunk 0 and dies before marking it done; worker 1,
    on the same journal, serves its own chunks and then helps chunk 0
    once the backoff deadline passes: every chunk served, chunk 0's
    batches bit-equal to repro's."""
    path = str(tmp_path / "tp.json")
    kw = dict(vocab=64, batch=2, seq_len=6, n_chunks=3, batches_per_chunk=2,
              seed=5, journal_path=path)
    dead = iter(TokenPipeline(worker=0, device="cpu", **kw))
    assert next(dead)[0] == 0                    # never marked done
    helper = TokenPipeline(worker=1, device="cpu", **kw)
    helper.journal.backoff_factor = 0.0          # help at once
    served = list(helper)
    assert {c for c, _ in served} == {0, 1, 2}
    want = {}
    for c, b in JTokenPipeline(**dict(kw, journal_path=None)):
        want.setdefault(c, []).append(b["tokens"])
    got = {}
    for c, b in served:
        got.setdefault(c, []).append(b["tokens"].numpy())
    for c in range(3):
        np.testing.assert_array_equal(np.stack(got[c]), np.stack(want[c]))
