"""The sharded §8 landing zone against the JAX reference, on the CPU.

One shard of 20 packets (520 DLRM records) striped over 4 replicas x 2
QPs in 2-packet tiles is fetched with ``BalboaIngest(shardings=...)``,
streamed (each tile through the tile decoder's plain preprocessing, and
again with a decoder that only splits the raw records' columns) and
synchronously (the host decode), on three meshes:

  * ``2x1`` (a 2-rank gloo world): dense and sparse rows over "data";
  * ``4x1`` (a 4-rank world): the same over four;
  * ``2x2`` (the 4-rank world): dense rows over "data", sparse rows over
    "data" and its 26 columns over "model".

Each rank's block must equal the reference's addressable shard on the
device at the same mesh coordinate (the reference runs on 4 host
devices, its meshes built with Auto axes): the raw stream, the
synchronous plane and every sparse word bit for bit, the preprocessed
stream's dense words within 1 ulp (``log1p`` differs by an ulp between
the libraries, as in ``test_torch_ingest.py``; the worst is printed).  Each rank's block is
also bit-equal to its rows of the port's unsharded fetch, the
``DTensor``'s ``full_tensor()`` equals that fetch, the stream report is
the unsharded one, and a rank decodes exactly the tiles that meet its
rows.  A shape the mesh does not divide raises in both packages, and a
zone on another device type than its mesh's raises in the port.

Process groups live only in subprocesses: each world is spawned by this
file run as a script; the reference runs in its own.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
N_DENSE, N_SPARSE, MOD, MTU = 13, 26, 1000, 4096
RPP = (MTU // 4) // (N_DENSE + N_SPARSE)          # 26 records a packet
N_PKTS, INDEX, TILE_PKTS = 20, 0, 2
CFG = dict(batch_bytes=N_PKTS * MTU, n_storage_nodes=4, qps_per_node=2,
           tile_pkts=TILE_PKTS, link_bw_pkts_per_tick=1)
# mesh -> (world, (data, model), spec of each key)
MESHES = {"2x1": (2, (2, 1), {"dense": ("data", None),
                              "sparse": ("data", None)}),
          "4x1": (4, (4, 1), {"dense": ("data", None),
                              "sparse": ("data", None)}),
          "2x2": (4, (2, 2), {"dense": ("data", None),
                              "sparse": ("data", "model")})}
DENSE_ULPS = 1

_REF = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec
sys.path.insert(0, sys.argv[2])
import test_torch_placement_ingest as T
from repro.core import ingest as jing
out = {"n_devices": len(jax.devices()), "meshes": {}, "raises": {}}
for name, (world, shape, specs) in T.MESHES.items():
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(shape),
                ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    shd = {k: NamedSharding(mesh, PartitionSpec(*s)) for k, s in specs.items()}
    ing = jing.BalboaIngest(
        jing.IngestConfig(**T.CFG), None, T.shard_fn(jing), shardings=shd,
        tile_to_batch=jing.make_dlrm_tile_decoder(T.N_DENSE, T.N_SPARSE,
                                                  T.MOD))
    streamed, _ = ing.fetch_shard_streaming(T.INDEX)
    raw, _ = jing.BalboaIngest(
        jing.IngestConfig(**T.CFG), None, T.shard_fn(jing), shardings=shd,
        tile_to_batch=jing.make_dlrm_tile_decoder(
            T.N_DENSE, T.N_SPARSE, None)).fetch_shard_streaming(T.INDEX)
    ing = jing.BalboaIngest(jing.IngestConfig(**T.CFG), None,
                            T.shard_fn(jing), decode_fn=T.decode_host,
                            shardings=shd)
    sync = ing.fetch_shard(T.INDEX)
    res = {}
    for plane, arrays in (("streamed", streamed), ("streamed_raw", raw),
                          ("sync", sync)):
        res[plane] = {}
        for k, a in arrays.items():
            assert a.sharding == shd[k], (a.sharding, shd[k])
            blocks = {}
            for s in a.addressable_shards:
                coord = tuple(int(i) for i in
                              np.argwhere(mesh.devices == s.device)[0])
                blocks[coord] = np.asarray(s.data)
            res[plane][k] = blocks
    out["meshes"][name] = res
mesh = Mesh(np.array(jax.devices()).reshape(4, 1), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)
rows = NamedSharding(mesh, PartitionSpec("data", None))
for what, fn in (
        ("zone", lambda: jing.DeviceLandingZone(
            {"x": ((6, 2), np.int32)}, {"x": rows})),
        ("stream", lambda: jing.BalboaIngest(
            jing.IngestConfig(**dict(T.CFG, batch_bytes=5 * T.MTU)), None,
            T.shard_fn(jing, 5), shardings={"dense": rows, "sparse": rows},
            tile_to_batch=jing.make_dlrm_tile_decoder(
                T.N_DENSE, T.N_SPARSE, T.MOD)).fetch_shard_streaming(0))):
    try:
        fn()
        out["raises"][what] = None
    except ValueError as e:
        out["raises"][what] = str(e)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
print("REF_OK")
"""


def shard_fn(pkg, n_pkts: int = N_PKTS):
    """Shard ``i`` of ``n_pkts`` packets of DLRM records, by ``pkg``'s
    ingest module's package (the two packages' generators are equal)."""
    syn = __import__(pkg.__name__.rsplit(".", 2)[0] + ".data.synthetic",
                     fromlist=["synthetic"])
    return lambda i: syn.encode_dlrm_packets(
        syn.dlrm_shard(i, RPP * n_pkts, N_DENSE, N_SPARSE))


def decode_host(raw):
    """The synchronous plane's host decode (``benchmarks/fig10_dlrm.py``'s
    ``_decode_host``), numpy only: the same in both packages."""
    words = np.frombuffer(raw.tobytes(), np.int32).reshape(-1, MTU // 4)
    recs = words[:, :RPP * (N_DENSE + N_SPARSE)].reshape(
        -1, N_DENSE + N_SPARSE)
    dense = np.log1p(np.maximum(recs[:, :N_DENSE], 0).astype(np.float32))
    sparse = (recs[:, N_DENSE:] % MOD).astype(np.int32)
    return {"dense": dense, "sparse": sparse}


def _bits(t):
    """A tensor's bit patterns (a raw record's dense words may be NaNs)."""
    import torch
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _rank_results(name: str, rank: int) -> dict:
    """One rank's results on mesh ``name``."""
    import torch
    from repro_torch.core import ingest as ting
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import NamedSharding, PartitionSpec
    from torch.distributed.tensor import DTensor
    _, (data, model), specs = MESHES[name]
    mesh = make_host_mesh(data, model, device="cpu")
    shd = {k: NamedSharding(mesh, PartitionSpec(*s)) for k, s in specs.items()}

    def ingest(shardings, **kw):
        return ting.BalboaIngest(ting.IngestConfig(**CFG), None,
                                 shard_fn(ting), shardings=shardings,
                                 device="cpu", **kw)

    dec = dict(tile_to_batch=ting.make_dlrm_tile_decoder(
        N_DENSE, N_SPARSE, MOD, impl="ref"))
    whole, whole_rep = ingest(None, **dec).fetch_shard_streaming(INDEX)
    ing = ingest(shd, **dec)
    streamed, rep = ing.fetch_shard_streaming(INDEX)
    raw_dec = dict(tile_to_batch=ting.make_dlrm_tile_decoder(
        N_DENSE, N_SPARSE, None))
    raw, _ = ingest(shd, **raw_dec).fetch_shard_streaming(INDEX)
    whole_raw, _ = ingest(None, **raw_dec).fetch_shard_streaming(INDEX)
    sync = ingest(shd, decode_fn=decode_host).fetch_shard(INDEX)
    whole_sync = ingest(None, decode_fn=decode_host).fetch_shard(INDEX)
    out = {"coordinate": tuple(mesh.get_coordinate()),
           "report_equal": (rep.ticks, rep.tiles, rep.events)
           == (whole_rep.ticks, whole_rep.tiles, whole_rep.events),
           "tiles": [ing.tiles_decoded, ing.tiles_skipped, rep.tiles]}
    for plane, arrays, ref in (("streamed", streamed, whole),
                               ("streamed_raw", raw, whole_raw),
                               ("sync", sync, whole_sync)):
        out[plane] = {}
        for k, a in arrays.items():
            assert isinstance(a, DTensor) and tuple(a.shape) == tuple(
                ref[k].shape), (k, type(a), a.shape)
            want = ref[k] if torch.is_tensor(ref[k]) else torch.from_numpy(
                ref[k])
            for d, (start, n) in enumerate(shd[k].block_bounds(want.shape)):
                want = want.narrow(d, start, n)
            out[plane][k] = {
                "block": a.to_local().numpy().copy(),
                "block_equal": torch.equal(_bits(a.to_local()), _bits(want)),
                "full_equal": torch.equal(_bits(a.full_tensor()),
                                          _bits(torch.as_tensor(ref[k])))}
    # the tiles whose rows meet this rank's block of either key
    r0, nr = shd["dense"].block_bounds(whole["dense"].shape)[0]
    out["tiles_meeting"] = sum(
        1 for st in rep.stripes for p0 in range(0, st.n_pkts, TILE_PKTS)
        if (st.pkt_start + p0) * RPP < r0 + nr
        and (st.pkt_start + min(p0 + TILE_PKTS, st.n_pkts)) * RPP > r0)
    if name == "4x1":
        rows = NamedSharding(mesh, PartitionSpec("data", None))
        out["raises"] = {}
        for what, fn in (
                ("zone", lambda: ting.DeviceLandingZone(
                    {"x": ((6, 2), torch.int32)}, {"x": rows},
                    device="cpu")),
                ("stream", lambda: ting.BalboaIngest(
                    ting.IngestConfig(**dict(CFG, batch_bytes=5 * MTU)),
                    None, shard_fn(ting, 5),
                    shardings={"dense": rows, "sparse": rows},
                    device="cpu", **dec).fetch_shard_streaming(0)),
                ("device", lambda: ting.DeviceLandingZone(
                    {"x": ((8, 2), torch.int32)}, {"x": rows},
                    device="meta"))):
            try:
                fn()
                out["raises"][what] = None
            except ValueError as e:
                out["raises"][what] = str(e)
    return out


def _worker(rank: int, world: int, store: str, out_dir: str):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res = {name: _rank_results(name, rank)
               for name, (w, _, _) in MESHES.items() if w == world}
        with open(Path(out_dir) / f"w{world}_rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + str(ROOT / "tests")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _start(args):
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(),
                            cwd=ROOT)


def _finish(proc, timeout=240):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("placement_ingest")
    procs = [_start(["-c", _REF, str(tmp / "ref.pkl"), str(ROOT / "tests")])]
    procs += [_start([__file__, str(w), str(tmp / f"store{w}"), str(tmp)])
              for w in (2, 4)]
    assert "REF_OK" in _finish(procs[0])
    for p in procs[1:]:
        _finish(p)
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    port = {}
    for name, (world, _, _) in MESHES.items():
        port[name] = []
        for r in range(world):
            with open(tmp / f"w{world}_rank{r}.pkl", "rb") as f:
                port[name].append(pickle.load(f)[name])
    return ref, port


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Float32 bit-pattern distance (non-negative floats)."""
    d = np.abs(a.view(np.int32).astype(np.int64)
               - b.view(np.int32).astype(np.int64))
    return int(d.max()) if d.size else 0


@pytest.mark.parametrize("plane", ["streamed", "streamed_raw", "sync"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_blocks_match_reference_shards(runs, name, plane):
    ref, port = runs
    assert ref["n_devices"] == 4
    world, shape, specs = MESHES[name]
    assert sorted(r["coordinate"] for r in port[name]) == sorted(
        ref["meshes"][name][plane]["dense"])
    worst = 0
    for r in port[name]:
        for k in specs:
            got = r[plane][k]["block"]
            want = ref["meshes"][name][plane][k][r["coordinate"]]
            assert got.shape == want.shape and got.dtype == want.dtype, \
                (k, got.shape, want.shape, got.dtype, want.dtype)
            if k == "dense" and plane == "streamed":
                worst = max(worst, _ulps(got, want))
            else:
                assert got.tobytes() == want.tobytes(), (k, r["coordinate"])
    print(f"{name} {plane}: {world} ranks, every block at its coordinate "
          f"== the reference's shard" + (
              f"; dense worst {worst} ulp (bound {DENSE_ULPS})"
              if plane == "streamed" else ", bit for bit"))
    assert worst <= DENSE_ULPS


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_equals_unsharded_and_skips_tiles(runs, name):
    _, port = runs
    for r in port[name]:
        assert r["report_equal"], r["coordinate"]
        for plane in ("streamed", "streamed_raw", "sync"):
            for k, v in r[plane].items():
                assert v["block_equal"] and v["full_equal"], (plane, k)
        decoded, skipped, tiles = r["tiles"]
        print(f"{name} rank at {r['coordinate']}: tiles decoded {decoded} "
              f"/ landed {tiles}, skipped {skipped}")
        assert decoded + skipped == tiles
        assert decoded == r["tiles_meeting"] < tiles


def test_indivisible_shape_and_wrong_device_raise(runs):
    ref, port = runs
    for what in ("zone", "stream"):
        assert "divisible by 4" in ref["raises"][what], ref["raises"]
        for r in port["4x1"]:
            assert "not divisible by the 4 shards" in r["raises"][what], \
                r["raises"]
    # a block never lands on another device type than its mesh's
    for r in port["4x1"]:
        assert "'cpu' mesh, not on meta" in r["raises"]["device"], r["raises"]


if __name__ == "__main__":
    import torch.multiprocessing as mp
    world = int(sys.argv[1])
    mp.start_processes(_worker, args=(world, sys.argv[2], sys.argv[3]),
                       nprocs=world, start_method="spawn")
