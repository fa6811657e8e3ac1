"""The port's data parallelism (parallel/mesh.py, the sharded train_step,
denoise_room and train) on the CPU: W = 2 gloo ranks against one process.

The ranks are processes running tests/torch_dist_worker.py (jax-free),
meeting through a file store under tmp_path; they run every case once for
the module. One process runs the same cases in-process for the reference.
The ranks differ from it only in the order of the sums: each forward sees
half the batch, and the gradients are averaged by an all-reduce. Held
(f32): the loss and the norms to STEP_REL relative, every gradient and
Adam moment element to GRAD_TOL of the largest, each parameter's and EMA's
update as tests/test_torch_train.py holds the port's against JAX's, and
the sharded room prediction to ROOM_TOL absolute (the JAX package's own
test of its mesh, tests/test_rooms.py, holds 1e-6). On the CPU a forward
of 2 clouds and one of 4 differ in their last bits (about 3e-6 at
max|out| 1.2 for this model), so the room model's head is scaled by 0.01,
as tests/test_torch_rooms.py scales it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_dist_worker as worker
from test_torch_train import TINY_OVERRIDES, assert_same_update, synthetic_tree

from p2p_bridge_tpu_torch import train
from p2p_bridge_tpu_torch.data.dataloader import NumpyLoader, PooledLoader
from p2p_bridge_tpu_torch.parallel.mesh import (DataMesh, initialize_distributed,
                                                make_data_mesh, shard_batch, shard_rows)
from p2p_bridge_tpu_torch.utils.args import parse_args

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
TIMEOUT = 300  # seconds a rank may take
# measured here: the loss and the norms 1.3e-7 to 1.8e-6 relative apart,
# gradients and moments up to 1.5e-5 of the largest (pvdl), the room 2.9e-7
STEP_REL = 1e-5
GRAD_TOL = 5e-5
ROOM_TOL = 1e-6


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, one_thread):
    """{rank: its results}, and the training configuration they ran."""
    if not torch.distributed.is_gloo_available():
        pytest.skip("this torch has no gloo backend")
    tmp = tmp_path_factory.mktemp("dist")
    synthetic_tree(tmp / "data")
    train_cfg = parse_args([
        "--config", str(ROOT / "configs" / "PVDS_PUNet.yaml"), "--save_dir", str(tmp / "runs"),
        "--data.data_dir", str(tmp / "data"), "--data.loader", "epoch",
        "--training.steps", "2", "--training.save_interval", "1000",
        "--training.log_interval", "1", "--use_wandb", "false", *TINY_OVERRIDES,
        "--training.bs", "4", "--data.pool_size", "8"])
    case = tmp / "case.json"
    case.write_text(json.dumps({"train_cfg": train_cfg}))
    env = {k: v for k, v in os.environ.items() if k != "P2PB_PLATFORM"}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen(
        [sys.executable, str(Path(worker.__file__)), str(r), str(WORLD), str(tmp / "store"),
         str(case), str(tmp)], cwd=tmp, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    return {r: dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)}, train_cfg


def prefixed(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def test_ranks_import_no_jax(ranks):
    results, _ = ranks
    assert not any(bool(results[r]["jax_loaded"]) for r in results)


@pytest.mark.parametrize("name", worker.STEP_CASES)
def test_a_sharded_train_step_matches_one_process(ranks, name):
    """punet: the K7 alignment on each rank's clouds; pvdl: conditioned,
    the bridge noise drawn for the global batch, two micro-batches. Both
    ranks end bit-equal to each other."""
    results, _ = ranks
    got = prefixed(results[0], f"{name}/")
    want = worker.step_case(name)
    for k in ("loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=STEP_REL, err_msg=k)
    grads = prefixed(want, "grad/")
    scale = max(np.abs(g).max() for g in grads.values())
    for n, g in grads.items():
        np.testing.assert_allclose(got[f"grad/{n}"], g, atol=GRAD_TOL * scale, err_msg=n)
    for moment in ("exp_avg", "exp_avg_sq"):
        m = prefixed(want, f"{moment}/")
        mscale = max(np.abs(v).max() for v in m.values())
        for n, v in m.items():
            np.testing.assert_allclose(got[f"{moment}/{n}"], v, atol=2 * GRAD_TOL * mscale,
                                       err_msg=f"{moment} {n}")
    clip = min(1.0, 1.0 / (float(want["grad_norm"]) + 1e-6))
    clipped = {n: g * clip for n, g in grads.items()}
    for what in ("param", "ema"):
        assert_same_update(prefixed(got, f"{what}/"), prefixed(want, f"{what}/"), clipped, what)
    other = prefixed(results[1], f"{name}/")
    for k, v in got.items():
        np.testing.assert_array_equal(other[k], v, err_msg=f"rank 1 {k}")


def test_a_sharded_denoise_room_matches_one_process(ranks):
    """Each rank samples half of every batch of 4 patches; the gathered
    predictions recompose the same room on both ranks, within ROOM_TOL of
    one process's: the overlap average with its chain, and with the
    outlier filter's keep masks."""
    results, _ = ranks
    got = prefixed(results[0], "room/")
    want = worker.room_case()
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, rtol=0, atol=ROOM_TOL, err_msg=k)
        np.testing.assert_array_equal(results[1][f"room/{k}"], got[k], err_msg=k)


def test_data_parallel_training_saves_once_from_rank_zero(ranks):
    """Two steps of train.train at a global batch of 4 (2 rows a rank):
    the ranks end with the same parameters, and rank 0 alone saved, once."""
    results, cfg = ranks
    assert int(results[0]["train_saves"]) == 1 and int(results[1]["train_saves"]) == 0
    assert os.path.isfile(os.path.join(cfg["output_dir"], "model.pt"))
    params = prefixed(results[0], "train_param/")
    assert params
    for n, v in params.items():
        np.testing.assert_array_equal(results[1][f"train_param/{n}"], v, err_msg=n)


class Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.asarray(i % self.n)}


@pytest.mark.parametrize("kind", ["epoch", "pool"])
def test_loader_shards_are_disjoint_and_cover_the_epoch(kind):
    """What each of 2 ranks draws in an epoch: no item twice, every item
    once (the epoch loader's batches; the pool's index stream)."""
    n = 24
    seen = []
    for rank in range(WORLD):
        if kind == "epoch":
            loader = NumpyLoader(Items(n), 3, seed=5, num_shards=WORLD, shard_index=rank)
            seen.append(np.concatenate([b["i"] for b in loader]))
        else:
            loader = PooledLoader(Items(n), 3, seed=5, num_shards=WORLD, shard_index=rank)
            stream = loader._index_stream()
            seen.append(np.array([next(stream) % n for _ in range(n // WORLD)]))
    assert all(len(s) == n // WORLD for s in seen)
    assert not set(seen[0]) & set(seen[1])
    assert sorted(np.concatenate(seen)) == list(range(n))


def test_train_loads_its_share_and_needs_a_batch_that_divides(monkeypatch, tmp_path):
    """Rank 1 of 2 asks for bs / 2 rows of shard 1; a bs of 3 raises."""
    asked = []

    def loader(cfg, num_shards=1, shard_index=0):
        asked.append((cfg["training"]["bs"], num_shards, shard_index))
        raise KeyboardInterrupt  # stop after the question

    monkeypatch.setattr(train, "get_dataloader", loader)
    cfg = {"training": {"bs": 4}, "output_dir": str(tmp_path)}
    mesh = DataMesh(1, WORLD, torch.device("cpu"))
    with pytest.raises(KeyboardInterrupt):
        train.train(cfg, "cpu", mesh=mesh)
    assert asked == [(2, WORLD, 1)]
    with pytest.raises(ValueError, match="divide"):
        train.train({"training": {"bs": 3}, "output_dir": str(tmp_path)}, "cpu", mesh=mesh)


def test_shards_take_each_micro_batch_in_rank_order():
    """Rank r's rows of a global batch of 8 in 2 micro-batches are r's
    share of each, so the ranks' micro-batch k is the global one's."""
    meshes = [DataMesh(r, WORLD, torch.device("cpu")) for r in range(WORLD)]
    assert [list(shard_rows(8, m, 2)) for m in meshes] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    batch = {"x": torch.arange(8.0)[:, None], "c": None}
    assert shard_batch(batch, meshes[1])["x"].flatten().tolist() == [4.0, 5.0, 6.0, 7.0]
    with pytest.raises(ValueError, match="divide"):
        shard_rows(6, meshes[0], 2)


def test_one_process_without_torchrun_is_a_mesh_of_one(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not initialize_distributed(device="cpu")
    mesh = make_data_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.backend, mesh.device) == (0, 1, None,
                                                                       torch.device("cpu"))
    x = torch.arange(4.0)
    assert mesh.all_gather(x) is x and torch.equal(mesh.all_reduce_mean_(x.clone()), x)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert make_data_mesh("cuda").device == torch.device("cuda", 3)
