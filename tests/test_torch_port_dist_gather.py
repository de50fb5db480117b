"""Port, data-parallel training: the eval hook's file exchange
(``file_exchange_gather``) against the JAX package's, on the CPU. Two
concurrent port processes sharing a work dir merge what the JAX function
merges from the same inputs; a dead peer raises ``TimeoutError``; a partial
``.tmp`` file is never read."""

import os
import pickle
import sys
import textwrap

import pytest

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from torch_dist_parity import REPO, finish, start

from vps_tpu.train.eval_hook import file_exchange_gather as j_gather
from vps_torch.train.eval_hook import file_exchange_gather

CHILD = textwrap.dedent("""
    import pickle, sys, time
    sys.path.insert(0, {repo!r})
    from vps_torch.train.eval_hook import file_exchange_gather

    host, work, delay = int(sys.argv[1]), sys.argv[2], float(sys.argv[3])
    with open(work + "/inputs.pkl", "rb") as f:
        results = pickle.load(f)[host]
    time.sleep(delay)  # host 1 publishes late: host 0 must wait for it
    merged = file_exchange_gather(work, epoch=1, results=results, host=host,
                                  n_hosts=2, barrier_timeout=60.0,
                                  poll_interval=0.05)
    with open(f"{{work}}/merged.host{{host}}.pkl", "wb") as f:
        pickle.dump(merged, f)
""").format(repo=str(REPO))


def _inputs():
    """Each host's results: frame ids to dicts of arrays, as the hook's."""
    import numpy as np

    rng = np.random.RandomState(0)
    return [{f"{v:04d}_{i:04d}": {"num_keep": np.array(h * 10 + i),
                                  "fcn_outputs": rng.rand(2, 3)}
             for v in range(h, 4, 2) for i in range(2)} for h in (0, 1)]


def test_two_concurrent_processes_merge_as_jax(tmp_path):
    """Host 0 starts first and polls until host 1 publishes; host 0's merge
    equals the JAX function's merge of the same two inputs, host 1 gets
    {}."""
    work = tmp_path / "port"
    work.mkdir()
    inputs = _inputs()
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    finish([start([sys.executable, "-c", CHILD, str(h), str(work),
                   {0: "0.0", 1: "1.0"}[h]]) for h in (0, 1)])
    with open(work / "merged.host0.pkl", "rb") as f:
        merged = pickle.load(f)
    with open(work / "merged.host1.pkl", "rb") as f:
        assert pickle.load(f) == {}

    jwork = str(tmp_path / "jax")
    assert j_gather(jwork, 1, inputs[1], host=1, n_hosts=2) == {}
    want = j_gather(jwork, 1, inputs[0], host=0, n_hosts=2, barrier_timeout=5)
    assert list(merged) == list(want)
    for k in want:
        assert sorted(merged[k]) == sorted(want[k])
        for key in want[k]:
            assert (merged[k][key] == want[k][key]).all()
    assert len(merged) == 8


def test_dead_peer_raises_timeout(tmp_path):
    """A peer that never publishes surfaces as TimeoutError on host 0, as
    the JAX function's does, naming the missing file."""
    kw = dict(epoch=3, results={"a": 1}, host=0, n_hosts=2,
              barrier_timeout=0.3, poll_interval=0.05)
    with pytest.raises(TimeoutError, match="host1"):
        file_exchange_gather(str(tmp_path / "port"), **kw)
    with pytest.raises(TimeoutError, match="host1"):
        j_gather(str(tmp_path / "jax"), **kw)


def test_partial_file_is_never_read(tmp_path):
    """A crashed writer's partial ``.tmp`` file is not published: host 0
    times out instead of unpickling it, then reads the peer's file once the
    atomic rename has published it."""
    tmpdir = tmp_path / ".eval_hook"
    tmpdir.mkdir()
    (tmpdir / "epoch5.host1.pkl.tmp").write_bytes(b"partial garbage")
    with pytest.raises(TimeoutError):
        file_exchange_gather(str(tmp_path), epoch=5, results={"a": 0}, host=0,
                             n_hosts=2, barrier_timeout=0.3,
                             poll_interval=0.05)
    assert file_exchange_gather(str(tmp_path), epoch=5, results={"b": 1},
                                host=1, n_hosts=2) == {}
    assert not os.path.exists(tmpdir / "epoch5.host1.pkl.tmp")
    assert file_exchange_gather(str(tmp_path), epoch=5, results={"a": 0},
                                host=0, n_hosts=2, barrier_timeout=0.3,
                                poll_interval=0.05) == {"a": 0, "b": 1}
