"""The port's room datasets (ScanNetPP, NPZFolderTest, ArkitNPZ) and its
loader on room configurations, against the JAX package's, item for item
and batch for batch (np.array_equal), on seeded npz trees."""

import numpy as np
import pytest

from p2p_bridge_tpu.data import arkitscenes as jax_arkit
from p2p_bridge_tpu.data import dataloader as jax_loader
from p2p_bridge_tpu.data import scannetpp as jax_snpp
from p2p_bridge_tpu.utils.config import Config
from p2p_bridge_tpu_torch.data import arkitscenes as port_arkit
from p2p_bridge_tpu_torch.data import dataloader as port_loader
from p2p_bridge_tpu_torch.data import scannetpp as port_snpp

N, FEATS = 64, 5
TRAIN, VAL = ["scene_a", "scene_b"], ["scene_c"]


def assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, (list, str)):
            assert va == vb, k
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb), err_msg=k)
            assert np.asarray(va).dtype == np.asarray(vb).dtype, k


def room_batch(rng, with_norm: bool, rgb: bool = True) -> dict:
    """One preprocess_batches npz: clean/noisy xyz (+ rgb), fp16 features,
    and center/scale where ``with_norm``."""
    noisy = rng.normal(size=(N, 3)) + 2.0
    clean = noisy + 0.02 * rng.normal(size=(N, 3))
    cols = [rng.uniform(size=(N, 3))] if rgb else []
    out = {"clean": np.concatenate([clean] + cols, 1).astype(np.float32),
           "noisy": np.concatenate([noisy] + cols, 1).astype(np.float32),
           "features": rng.normal(size=(N, FEATS)).astype(np.float16),
           "idxs": rng.integers(0, 1000, N)}
    if with_norm:
        out["center"] = noisy.mean(0).astype(np.float32)
        out["scale"] = np.float32(3.0)
    return out


@pytest.fixture(scope="module")
def snpp_tree(tmp_path_factory):
    """Three scenes of three batches each (one scene's without center and
    scale, one with xyz only), the split files, one corrupt npz in a
    training scene and a stray file the dataset must not list."""
    root = tmp_path_factory.mktemp("snpp")
    rng = np.random.default_rng(0)
    for s, scene in enumerate(TRAIN + VAL):
        (root / scene).mkdir()
        for i in range(3):
            np.savez(root / scene / f"points_{i}.npz",
                     **room_batch(rng, with_norm=s != 1, rgb=s != 2))
    (root / "scene_a" / "points_9.npz").write_bytes(b"not an npz file")
    (root / "scene_a" / "notes.txt").write_text("stray")
    (root / "unlisted").mkdir()
    np.savez(root / "unlisted" / "points_0.npz", **room_batch(rng, True))
    splits = root / "splits"
    splits.mkdir()
    (splits / "snpp_train.txt").write_text("\n".join(TRAIN) + "\n")
    (splits / "snpp_val.txt").write_text("\n".join(VAL) + "\n")
    return root


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
@pytest.mark.parametrize("swap", [False, True], ids=["x0_clean", "legacy_key_swap"])
@pytest.mark.parametrize("mode", ["training", "validation"])
def test_scannetpp_items_equal_the_original(snpp_tree, augment, swap, mode):
    """Every item, the corrupt file's retries included, in both directions
    of the key swap; x0 = clean unless the swap is asked for."""
    kw = dict(mode=mode, additional_features=True, augment=augment,
              splits_path=str(snpp_tree / "splits"), legacy_key_swap=swap, seed=3)
    port = port_snpp.ScanNetPP(str(snpp_tree), **kw)
    orig = jax_snpp.ScanNetPP(str(snpp_tree), **kw)
    assert port.scene_batches == orig.scene_batches
    assert len(port) == (7 if mode == "training" else 3)
    for idx in range(len(port)):
        assert_items_equal(port[idx], orig[idx])
    if mode == "training":
        corrupt = [i for i, b in enumerate(port.scene_batches) if b["npz"].endswith("_9.npz")]
        item = port[corrupt[0]]  # retried onto another batch
        assert item["idx"] != corrupt[0] and item["noisy_features"].shape == (N, FEATS)
        if not (augment or swap):
            # x0 = clean: clean_points are the "clean" array's, permuted (a
            # batch with center and scale is already normalised)
            d = np.load(port.scene_batches[1]["npz"])
            np.testing.assert_array_equal(np.sort(port[1]["clean_points"], 0),
                                          np.sort(d["clean"][:, :3], 0))


def test_scannetpp_gives_up_on_a_tree_of_corrupt_files(tmp_path):
    (tmp_path / "s").mkdir()
    (tmp_path / "s" / "points_0.npz").write_bytes(b"broken")
    (tmp_path / "splits").mkdir()
    (tmp_path / "splits" / "snpp_train.txt").write_text("s\n")
    for module in (port_snpp, jax_snpp):
        ds = module.ScanNetPP(str(tmp_path), splits_path=str(tmp_path / "splits"))
        with pytest.raises(RuntimeError, match="too many corrupt"):
            ds[0]


@pytest.mark.parametrize("features", [None, "features", "missing"])
def test_npz_folder_test_items_equal_the_original(snpp_tree, features):
    for scene in TRAIN + VAL:
        port = port_snpp.NPZFolderTest(str(snpp_tree / scene), features)
        orig = jax_snpp.NPZFolderTest(str(snpp_tree / scene), features)
        assert port.files == orig.files
        for idx in range(len(port)):
            if port.files[idx] == "points_9.npz":
                continue  # the corrupt one: NPZFolderTest has no retry
            assert_items_equal(port[idx], orig[idx])


def arkit_batch(rng, key="dino") -> dict:
    iphone = rng.normal(size=(N, 6)).astype(np.float32)
    faro = (iphone + 0.01 * rng.normal(size=(N, 6))).astype(np.float32)
    return {"faro": faro, "iphone": iphone, key: rng.normal(size=(N, FEATS)).astype(np.float16)}


@pytest.fixture(scope="module", params=["mode_dirs", "flat"])
def arkit_tree(request, tmp_path_factory):
    """The two layouts ArkitNPZ reads: <mode>/<scene>/points*.npz, or flat
    *.npz files beside scene directories."""
    root = tmp_path_factory.mktemp(f"arkit_{request.param}")
    rng = np.random.default_rng(1)
    if request.param == "mode_dirs":
        for mode, scenes in (("training", ("s0", "s1")), ("validation", ("s2",))):
            for scene in scenes:
                (root / mode / scene).mkdir(parents=True)
                for i in range(2):
                    np.savez(root / mode / scene / f"points_{i}.npz", **arkit_batch(rng))
                np.savez(root / mode / scene / "other.npz", **arkit_batch(rng))
    else:
        for i in range(5):
            np.savez(root / f"room{i}.npz", **arkit_batch(rng))
        (root / "s9").mkdir()
        np.savez(root / "s9" / "points_0.npz", **arkit_batch(rng))
    return root


@pytest.mark.parametrize("features", ["dino", None, "absent"])
@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
@pytest.mark.parametrize("mode", ["training", "validation"])
def test_arkit_items_equal_the_original(arkit_tree, features, augment, mode):
    kw = dict(mode=mode, features=features, augment=augment, seed=5)
    port = port_arkit.ArkitNPZ(str(arkit_tree), **kw)
    orig = jax_arkit.ArkitNPZ(str(arkit_tree), **kw)
    assert port.scene_batches == orig.scene_batches and len(port) > 0
    for idx in list(range(len(port))) + [len(port) + 1]:  # an index past the end wraps
        item = port[idx]
        assert_items_equal(item, orig[idx])
        assert item["clean_points"] is item["hr_points"]
        assert item["noisy_points"] is item["lr_points"]
        assert ("noisy_features" in item) == (features == "dino")


def room_cfg(dataset, data_dir, splits=None, loader=None, augment=True):
    data = {"dataset": dataset, "data_dir": str(data_dir), "npoints": N, "augment": augment,
            "point_features": "dino" if dataset == "ArKitPP" else "features"}
    if splits is not None:
        data["splits_path"] = str(splits)
    if loader is not None:
        data["loader"] = loader
    return {"data": data, "training": {"bs": 2, "seed": 7}, "sampling": {"bs": 3}}


def assert_loaders_equal(cfg, shards=1, shard=0):
    port_train, port_val = port_loader.get_dataloader(cfg, shards, shard)
    jax_train, jax_val = jax_loader.get_dataloader(Config(cfg), shards, shard)
    assert type(port_train).__name__ == type(jax_train).__name__ == "NumpyLoader"
    assert len(port_train) == len(jax_train) > 0
    port_it, jax_it = port_loader.save_iter(port_train), jax_loader.save_iter(jax_train)
    for _ in range(2 * len(port_train) + 1):  # across two epoch boundaries
        assert_items_equal(next(port_it), next(jax_it))
    vals = list(port_val)
    assert len(vals) == len(list(jax_val)) > 0
    for got, want in zip(vals, jax_val):
        assert_items_equal(got, want)


@pytest.mark.parametrize("shards", [(1, 0), (2, 0), (2, 1)], ids=["one", "shard0of2", "shard1of2"])
def test_scannetpp_loader_equals_the_original(snpp_tree, shards):
    """get_dataloader on a ScanNetPP config: the epoch loader by default,
    data.point_features, data.splits_path, seeds seed / seed + 1."""
    assert_loaders_equal(room_cfg("ScanNetPP", snpp_tree, snpp_tree / "splits"), *shards)


@pytest.mark.parametrize("shards", [(1, 0), (2, 1)], ids=["one", "shard1of2"])
def test_arkit_loader_equals_the_original(arkit_tree, shards):
    assert_loaders_equal(room_cfg("ArKitPP", arkit_tree), *shards)


def test_room_loader_takes_the_pool_when_asked(snpp_tree):
    cfg = room_cfg("ScanNetPP", snpp_tree, snpp_tree / "splits", loader="pool")
    cfg["data"]["pool_size"] = 4
    port, _ = port_loader.get_dataloader(cfg)
    orig, _ = jax_loader.get_dataloader(Config(cfg))
    for loader in (port, orig):
        loader._fill_initial()
    assert_items_equal(port._pool, orig._pool)
    cfg["data"]["dataset"] = "Unknown"
    with pytest.raises(NotImplementedError, match="Unknown"):
        port_loader.get_dataloader(cfg)
