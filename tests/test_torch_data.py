"""The port's data pipeline (``repro_torch.data.pipeline``) against the JAX
package's ``repro.data.pipeline``: the same numpy batches, bit for bit, for
every arch's smoke config at several steps and hosts; and twins of the JAX
package's own data tests (tests/test_substrate.py)."""
import numpy as np
import pytest

from repro.configs import get_smoke_config as jget_smoke
from repro.data import pipeline as jpipe
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.data.pipeline import (DataConfig, PrefetchingLoader,
                                       SyntheticTokenStream, make_loader)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batches_equal_jax_bit_for_bit(arch):
    """Every key (tokens, labels, positions; mrope's (3, B, S) positions;
    the embeds of input_mode 'embeddings'), dtype and bit, at steps 0, 1 and
    7, for one host and for each of two."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    for n_hosts in (1, 2):
        for host in range(n_hosts):
            kw = dict(seq_len=16, global_batch=4, seed=11, n_hosts=n_hosts,
                      host_id=host)
            mine = make_loader(cfg, DataConfig(**kw))
            ref = jpipe.make_loader(jcfg, jpipe.DataConfig(**kw))
            for step in (0, 1, 7):
                mine.step = ref.step = step
                got, want = next(mine), next(ref)
                assert got.keys() == want.keys()
                for k in want:
                    assert got[k].dtype == want[k].dtype, (arch, k)
                    np.testing.assert_array_equal(got[k], want[k],
                                                  err_msg=f"{arch} {k}")
                assert mine.state_dict() == ref.state_dict()
    if cfg.rope_kind == "mrope":
        assert got["positions"].shape == (3, 2, 16)
    assert ("embeds" in got) == (cfg.input_mode == "embeddings")


def test_data_deterministic_and_resumable():
    cfg = get_smoke_config("stablelm-3b")
    dcfg = DataConfig(seq_len=16, global_batch=4, seed=9)
    s1 = make_loader(cfg, dcfg)
    b0, b1 = next(s1), next(s1)
    s2 = make_loader(cfg, dcfg)
    s2.load_state_dict({"step": 1, "seed": 9})
    b1b = next(s2)
    np.testing.assert_array_equal(b1["tokens"], b1b["tokens"])
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    with pytest.raises(ValueError, match="seed"):
        s2.load_state_dict({"step": 1, "seed": 8})


def test_data_hosts_get_disjoint_rows():
    cfg = get_smoke_config("stablelm-3b")
    h0 = next(make_loader(cfg, DataConfig(seq_len=8, global_batch=4,
                                          seed=5, n_hosts=2, host_id=0)))
    h1 = next(make_loader(cfg, DataConfig(seq_len=8, global_batch=4,
                                          seed=5, n_hosts=2, host_id=1)))
    assert h0["tokens"].shape[0] == 2 and h1["tokens"].shape[0] == 2
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    with pytest.raises(ValueError, match="divide"):
        SyntheticTokenStream(cfg, DataConfig(global_batch=3, n_hosts=2))


def test_prefetch_preserves_stream():
    cfg = get_smoke_config("stablelm-3b")
    dcfg = DataConfig(seq_len=8, global_batch=2, seed=3)
    direct = make_loader(cfg, dcfg)
    want = [next(direct)["tokens"] for _ in range(4)]
    pref = PrefetchingLoader(iter(make_loader(cfg, dcfg)), depth=2)
    got = [next(pref)["tokens"] for _ in range(4)]
    pref.close()
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_prefetch_close_joins_its_thread_and_errors_reach_the_consumer():
    """``close`` ends the fill thread though the queue is full (the JAX
    package's thread stays blocked on it); an error of the iterator is
    raised by ``next`` after the items before it."""
    cfg = get_smoke_config("stablelm-3b")
    pref = PrefetchingLoader(iter(make_loader(cfg, DataConfig(
        seq_len=8, global_batch=2))), depth=1)
    next(pref)
    pref.close()
    assert not pref._thread.is_alive()

    def failing():
        yield 1
        raise RuntimeError("stream broke")
    pref = PrefetchingLoader(failing(), depth=2)
    assert next(pref) == 1
    with pytest.raises(RuntimeError, match="stream broke"):
        next(pref)
    pref.close()
    assert not pref._thread.is_alive()


def test_mrope_positions_shape():
    cfg = get_smoke_config("qwen2-vl-7b")
    b = next(make_loader(cfg, DataConfig(seq_len=8, global_batch=2)))
    assert b["positions"].shape == (3, 2, 8)
    assert "embeds" in b                       # vlm stub frontend
