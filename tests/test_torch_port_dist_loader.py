"""Port, data-parallel training: the train loader's shards
(``TrainLoader(num_hosts, host_id)``) against the JAX package's loader, on
a stub dataset whose samples record their index and their random draws,
with 0 workers. Cheap tests only."""

import numpy as np
import pytest

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_tpu.data.loader import TrainLoader as JTrainLoader
from vps_torch.data.loader import TrainLoader


class _Stub:
    """n samples; each is its index and two draws of its RandomState."""

    def __init__(self, n, repeat_times=None):
        self.n = n
        if repeat_times:
            self.repeat_times = repeat_times

    def __len__(self):
        return self.n

    def prepare_train(self, idx, rng):
        return {"idx": np.array(idx, np.int64),
                "draw": rng.rand(2).astype(np.float32)}


def _epochs(loader, epochs=2):
    return [list(loader.epoch(e)) for e in range(epochs)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("host", [0, 1])
@pytest.mark.parametrize("n,batch,repeat", [(8, 2, None), (12, 3, 2)])
def test_rank_batches_match_jax(host, n, batch, repeat):
    """Where n * repeat is a multiple of batch x hosts, rank ``host`` of 2
    yields the JAX loader's batches for that host, epoch by epoch: its
    shard of the permutation, the per-sample seeds, the step count."""
    kw = dict(seed=5, num_hosts=2, host_id=host, num_workers=0)
    port = TrainLoader(_Stub(n, repeat), batch, **kw)
    jax_loader = JTrainLoader(_Stub(n, repeat), batch, **kw)
    assert port.steps_per_epoch() == jax_loader.steps_per_epoch()
    got, want = _epochs(port), _epochs(jax_loader)
    for e in range(2):
        assert len(got[e]) == port.steps_per_epoch()
        _assert_batches_equal(got[e], want[e])
    # the two ranks' shards of an epoch are disjoint and cover the data
    other = TrainLoader(_Stub(n, repeat), batch, seed=5, num_hosts=2,
                        host_id=1 - host, num_workers=0)
    seen = [int(i) for b in got[0] + list(other.epoch(0)) for i in b["idx"]]
    assert sorted(seen) == sorted(list(range(n)) * (repeat or 1))


def test_uneven_n_every_rank_yields_steps_per_epoch():
    """n = 5 over 2 ranks, batch 1: steps_per_epoch is 2, and each port
    rank yields exactly 2 batches (rank 0 the JAX loader's first 2). The
    JAX loader yields 3 on host 0 and 2 on host 1: host 0's third step
    would wait in a collective that host 1 never joins."""
    ranks = [TrainLoader(_Stub(5), 1, seed=0, num_hosts=2, host_id=h,
                         num_workers=0) for h in (0, 1)]
    jax_hosts = [JTrainLoader(_Stub(5), 1, seed=0, num_hosts=2, host_id=h,
                              num_workers=0) for h in (0, 1)]
    for port, jax_loader in zip(ranks, jax_hosts):
        assert port.steps_per_epoch() == jax_loader.steps_per_epoch() == 2
        got = list(port.epoch(0))
        assert len(got) == port.steps_per_epoch()
        _assert_batches_equal(got, list(jax_loader.epoch(0))[:2])
    assert [len(list(j.epoch(0))) for j in jax_hosts] == [3, 2]
    with pytest.raises(ValueError):
        TrainLoader(_Stub(5), 1, num_hosts=2, host_id=2)
