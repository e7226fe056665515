"""The port's distributed MapReduce pipeline against the JAX package's.

* ``wordcount_map`` gives bit for bit ``wordcount_map_jax``'s words (int64
  with a 31-bit mask in place of uint32 wraparound).
* A one-rank gloo pipeline equals the reference's single-device
  ``make_pipeline`` at rtol 1e-5, with and without the kernel combine (its
  plain version here: the tensors are on the CPU), and the reference's
  sort semantics.
* Four gloo ranks, each its own process, in a subprocess with a timeout of
  its own, equal the port engine's dense sums at rtol 1e-5: the shuffle
  really crosses ranks.

The gloo group of the in-process tests lives on a ``HashStore``: no
socket, one rank.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro.mapreduce import JOBS as J_JOBS
from repro.mapreduce import make_input as j_make_input
from repro.mapreduce.distributed import identity_map_jax
from repro.mapreduce.distributed import make_pipeline as j_make_pipeline
from repro.mapreduce.distributed import wordcount_map_jax
from repro_torch.compat import has_cuda
from repro_torch.core.hadoop.params import HadoopParams, MiB
from repro_torch.kernels import seg_combine
from repro_torch.mapreduce import (
    JOBS,
    MapReduceEngine,
    identity_map,
    make_input,
    make_pipeline,
    wordcount_map,
)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture
def gloo_group():
    """The default process group: gloo, one rank, on an in-memory store."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _dense_expected(keys, values, key_space):
    """Ground truth via the port's engine (numpy combiner): dense sums."""
    job = JOBS["wordcount"]
    hp = HadoopParams(
        pNumMappers=2, pNumReducers=4, pUseCombine=job.use_combine,
        pSplitSize=keys.shape[0] * job.pair_width, pTaskMem=8.0 * MiB,
    )
    jc = MapReduceEngine(hp, job, use_kernel_combine=False).run_job(keys, values)
    ok, ov = jc.output
    dense = np.zeros(key_space, np.float32)
    np.add.at(dense, ok % key_space, ov)
    return dense


def _mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


# ---------------------------------------------------------------- map


@pytest.mark.parametrize("key_space", [8192, 1024, 100])
def test_wordcount_map_is_bit_exact_against_the_reference(key_space):
    keys, values = make_input(JOBS["wordcount"], 5000, seed=4)
    rng = np.random.default_rng(1)
    edge = np.concatenate([keys.astype(np.int32),
                           rng.integers(0, 2**31 - 1, 2000, dtype=np.int64)
                           .astype(np.int32),
                           np.asarray([0, 1, 2**31 - 1], np.int32)])
    vals = np.ones(edge.shape[0], np.float32)
    want_w, want_v = wordcount_map_jax(jax.numpy.asarray(edge), jax.numpy.asarray(vals),
                                       key_space=key_space)
    got_w, got_v = wordcount_map(torch.from_numpy(edge), torch.from_numpy(vals),
                                 key_space=key_space)
    assert got_w.dtype == torch.int32
    assert np.array_equal(got_w.numpy(), np.asarray(want_w))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))


def test_identity_map_matches_the_reference():
    keys, values = make_input(JOBS["sort"], 300, seed=5)
    want_k, want_v = identity_map_jax(jax.numpy.asarray(keys.astype(np.int32)),
                                      jax.numpy.asarray(values), key_space=256)
    got_k, got_v = identity_map(torch.from_numpy(keys.astype(np.int32)),
                                torch.from_numpy(values), key_space=256)
    assert np.array_equal(got_k.numpy(), np.asarray(want_k))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))


# ------------------------------------------------------ one gloo rank


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("key_space,n,seed", [(1024, 4096, 0), (512, 2048, 3)])
def test_one_rank_pipeline_matches_the_reference(gloo_group, use_kernel,
                                                 key_space, n, seed):
    keys, values = make_input(JOBS["wordcount"], n, seed=seed)
    j_keys, j_values = j_make_input(J_JOBS["wordcount"], n, seed=seed)
    assert np.array_equal(keys, j_keys) and np.array_equal(values, j_values)
    want = np.asarray(j_make_pipeline(_mesh(), key_space=key_space,
                                      use_pallas=use_kernel)(
        j_keys.astype(np.int32), j_values))
    before = seg_combine.launches
    got = make_pipeline(key_space=key_space, use_kernel=use_kernel,
                        device=CPU)(keys.astype(np.int32), values)
    assert seg_combine.launches == before      # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == (key_space,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), _dense_expected(keys, values, key_space),
                               rtol=1e-5)


def test_one_rank_identity_pipeline_sort_semantics(gloo_group):
    keys, values = make_input(JOBS["sort"], 2000, seed=5)
    got = make_pipeline(map_fn=identity_map, key_space=256, device=CPU)(
        keys.astype(np.int32), values)
    want = np.asarray(j_make_pipeline(_mesh(), map_fn=identity_map_jax,
                                      key_space=256)(keys.astype(np.int32), values))
    dense = np.zeros(256, np.float32)
    np.add.at(dense, keys % 256, values)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-5)


def test_pipeline_refuses_what_it_cannot_run(gloo_group):
    with pytest.raises(ValueError, match="split"):
        make_pipeline(key_space=64, device=CPU)(np.arange(5, dtype=np.int32),
                                                np.ones(4, np.float32))
    if not has_cuda():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_pipeline(key_space=64)


def test_pipeline_needs_an_initialised_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_pipeline(key_space=64, device=CPU)


# ------------------------------------------- four gloo ranks, real shuffle

_RANKS = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, world, port, out):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        from repro_torch.mapreduce import JOBS, make_input, make_pipeline
        keys, values = make_input(JOBS["wordcount"], 8192)
        pipe = make_pipeline(key_space=1024, device="cpu")
        res = pipe(keys.astype(np.int32), values)
        if rank == 0:
            np.save(out, res.numpy())
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(rank_main, args=(4, port, sys.argv[1]), nprocs=4, join=True)
        print("OK")
""")


def test_four_gloo_ranks_match_the_engine(tmp_path):
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    out = tmp_path / "out.npy"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(out)], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout
    keys, values = make_input(JOBS["wordcount"], 8192)
    np.testing.assert_allclose(np.load(out), _dense_expected(keys, values, 1024),
                               rtol=1e-5)
