"""Multi-device rendering of the PyTorch port (parallel/shard.py,
distributed.py, Renderer(mesh=), pixel_ids, the ReSTIR halo, the sharded
training step, the CLI's --mesh and --distributed) against
`lumenrenderer_tpu`'s on the CPU.

JAX runs 8 virtual CPU devices in one process; the port runs one process a
rank in a gloo group. So the multi-rank checks spawn 2 and 4 processes
(tests/_torch_dist_worker.py, one spawn per world size holding every
check, with a timeout), and the tests read their results. Bars:
- pixel_ids: the camera and motion vectors equal JAX's exactly; row
  slices of the frame (brute force, the full frame's draws sliced)
  concatenated equal the full frame within 1e-6;
- the mesh Renderer (tests/test_parallel.py:120): the 48-spp image's mean
  within 3% of the plain Renderer's, the mean absolute deviation under 15%
  of the mean (the ranks draw other numbers, so the comparison is
  statistical, as in JAX);
- ReSTIR under the mesh finite and lit (:168);
- the halo (:207, W 128, H 64, 4 ranks): each rank's reservoirs equal JAX's
  shard_map run with JAX's draws within rtol 1e-5, and the seam rows
  agree with the unpartitioned pass where the clamped variant does not;
- the sharded training step against the one-process step with the same
  draws: loss and gradients within rtol 1e-4, parameters equal on every
  rank.
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import n, port_camera, t
from _torch_dist_worker import RowSlices, train_setup
from lumenrenderer_tpu.core import camera as jcamera
from lumenrenderer_tpu.parallel import shard as jshard
from lumenrenderer_tpu.restir import di as jdi
from lumenrenderer_tpu.scene import presets as jpresets
from lumenrenderer_tpu_torch.core import camera as pcamera
from lumenrenderer_tpu_torch.integrator import wavefront as pwf
from lumenrenderer_tpu_torch.parallel import distributed, shard
from lumenrenderer_tpu_torch.render import renderer as prenderer
from lumenrenderer_tpu_torch.scene import presets

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_dist_worker.py"
TIMEOUT = 300
HALO_W, HALO_H, HALO_RANKS = 128, 64, 4
FIELDS = ("light_idx", "bary", "w_sum", "m", "w_out", "p_hat")


def _env():
    env = {k: v for k, v in os.environ.items() if k not in (
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _spawn(cmds, cwd, env):
    """Run the commands at once; (return codes, outputs); fail the test at
    TIMEOUT seconds."""
    procs = [subprocess.Popen(c, cwd=cwd, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c, e in zip(cmds, env)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"ranks ran past {TIMEOUT} s")
    return [p.returncode for p in procs], outs


# -- the JAX halo reference (tests/test_parallel.py:207's setup) -------------

def _halo_setup():
    n_px = HALO_W * HALO_H
    gy = (np.arange(n_px) // HALO_W).astype(np.float32)
    gx = (np.arange(n_px) % HALO_W).astype(np.float32)
    inp = {
        "halo_w": np.int64(HALO_W), "halo_h": np.int64(HALO_H),
        "halo_position": np.stack([gx * 0.01, gy * 0.01,
                                   np.zeros(n_px, np.float32)], -1),
        "halo_normal": np.broadcast_to(np.float32([0, 0, 1]),
                                       (n_px, 3)).copy(),
        "halo_base_color": np.full((n_px, 3), 0.8, np.float32),
        "halo_hit": np.ones(n_px, bool),
        "halo_res_light_idx": np.zeros(n_px, np.int32),
        "halo_res_bary": np.full((n_px, 2), 0.3, np.float32),
        "halo_res_w_sum": np.zeros(n_px, np.float32),
        "halo_res_m": np.ones(n_px, np.float32),
        "halo_res_w_out": 1.0 + gy,
        "halo_res_p_hat": np.ones(n_px, np.float32),
    }
    return inp


def _jax_halo(inp):
    """JAX's unpartitioned pass, its shard_map runs with and without the
    halo, and the draws each shard takes (one key, so the same on every
    shard)."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    sc = jpresets.cornell_box(with_blocks=True)[0].build()
    cfg = jdi.RestirConfig(spatial_samples=8, spatial_radius=8,
                           spatial_iterations=1, biased=True)
    hl = HALO_H // HALO_RANKS
    sd = types.SimpleNamespace(
        position=jnp.asarray(inp["halo_position"]),
        normal=jnp.asarray(inp["halo_normal"]),
        base_color=jnp.asarray(inp["halo_base_color"]))
    hit = jnp.asarray(inp["halo_hit"])
    res = jdi.Reservoir(**{f: jnp.asarray(inp[f"halo_res_{f}"])
                           for f in FIELDS})
    key = jax.random.PRNGKey(7)
    full = jdi.spatial_pass(sc, sd, res, hit, cfg, HALO_W, HALO_H, key)
    mesh = jshard.make_mesh(jax.devices()[:HALO_RANKS])

    def sharded(halo):
        def f(pos, nrm, alb, h, r):
            sdl = types.SimpleNamespace(position=pos, normal=nrm,
                                        base_color=alb)
            return jdi.spatial_pass(
                sc, sdl, r, h, cfg, HALO_W, hl, key,
                halo=(jshard.TILE_AXIS, HALO_RANKS) if halo else None)
        sh = P(jshard.TILE_AXIS)
        rspec = jax.tree_util.tree_map(lambda _: sh, res)
        return shard_map(f, mesh=mesh, in_specs=(sh, sh, sh, sh, rspec),
                         out_specs=rspec, check_rep=False)(
            sd.position, sd.normal, sd.base_color, hit, res)

    out = {"full": full, "halo": sharded(True), "clamp": sharded(False)}
    k1, k2, k3 = jax.random.split(jax.random.fold_in(key, 0), 3)
    for variant, h_ext in (("halo", hl + 2 * min(8, hl)), ("clamp", hl)):
        rows = HALO_W * h_ext
        for i, (k, shape) in enumerate(((k1, (rows, 8)), (k2, (rows, 8)),
                                        (k3, (rows, 1)))):
            inp[f"halo_draws_{variant}_{i}"] = np.asarray(
                jax.random.uniform(k, shape))
    return {k: {f: np.asarray(getattr(v, f)) for f in FIELDS}
            for k, v in out.items()}


_RUNS = {}


def _ranks(world, tmp_path_factory):
    """The workers' results for a group of `world` ranks (spawned once)."""
    if world not in _RUNS:
        d = tmp_path_factory.mktemp(f"world{world}")
        inp = {"world": np.int64(world)}
        ref = None
        if world == HALO_RANKS:
            inp.update(_halo_setup())
            ref = _jax_halo(inp)
        np.savez(d / "in.npz", **inp)
        port = shard.free_port()
        rcs, outs = _spawn(
            [[sys.executable, str(WORKER), str(r), str(world), str(port),
              str(d / "in.npz"), str(d / f"out{r}.npz")]
             for r in range(world)], REPO, [_env()] * world)
        for r, (rc, out) in enumerate(zip(rcs, outs)):
            assert rc == 0 and "RANK_OK" in out, f"rank {r}:\n{out[-3000:]}"
        _RUNS[world] = ([dict(np.load(d / f"out{r}.npz"))
                         for r in range(world)], ref)
    return _RUNS[world]


# -- pixel_ids ---------------------------------------------------------------

def _jax_camera():
    """The Cornell camera, its previous pose a small step aside."""
    from lumenrenderer_tpu.core.camera import Camera

    prev = Camera.look_at(eye=(0.55, 0.5, 2.0), target=(0.5, 0.5, 0.0),
                          fov_y_deg=40.0)
    return jpresets.cornell_box()[1](1.0).with_previous(prev, 40.0)


@pytest.mark.parametrize("rows", [(0, 8), (5, 11), (12, 16)])
def test_primary_rays_and_motion_with_pixel_ids_match_jax(rows):
    w, h = 16, 16
    jcam = _jax_camera()
    cam = port_camera(jcam)
    ids = np.arange(rows[0] * w, rows[1] * w, dtype=np.int32)
    for jitter in ("halton", "center"):
        jo, jd = jcamera.generate_primary_rays(
            jcam, w, h, jnp.uint32(3), jitter=jitter,
            pixel_ids=jnp.asarray(ids))
        po, pd = pcamera.generate_primary_rays(cam, w, h, 3, jitter=jitter,
                                               pixel_ids=t(ids))
        assert po.shape == (ids.size, 3)
        np.testing.assert_array_equal(n(po), np.asarray(jo))
        np.testing.assert_array_equal(n(pd), np.asarray(jd))
    # hits inside the box; the reprojection's matmul sums in another order
    # than XLA's, hence test_torch_core's 1e-5, while the pixel centres
    # that pixel_ids gives are exact (the motion of a point on its own
    # pixel's centre ray is the same expression in both)
    g = np.random.default_rng(0)
    pos = g.uniform(0, 1, (ids.size, 3)).astype(np.float32)
    valid = g.random(ids.size) > 0.2
    ref = jcamera.motion_vectors(jnp.asarray(pos), jnp.asarray(valid), jcam,
                                 w, h, pixel_ids=jnp.asarray(ids))
    got = pcamera.motion_vectors(t(pos), t(valid), cam, w, h,
                                 pixel_ids=t(ids))
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=0, atol=1e-5)
    rows_of_full = pcamera.motion_vectors(
        t(np.zeros((w * h, 3), np.float32)), t(np.ones(w * h, bool)), cam,
        w, h)[ids]
    at_origin = pcamera.motion_vectors(
        t(np.zeros((ids.size, 3), np.float32)), t(np.ones(ids.size, bool)),
        cam, w, h, pixel_ids=t(ids))
    np.testing.assert_array_equal(n(at_origin), n(rows_of_full))


def test_row_slices_of_the_frame_equal_the_full_frame():
    """render_wavefront on two row slices (per-ray brute force, the full
    frame's draws sliced to the rows) concatenated equals the full frame."""
    sc, cam, cfg, isect, occl, _ = train_setup()
    cfg = pwf.RenderConfig(width=16, height=16, max_depth=3, bsdf="disney",
                           light_strategy="mis")
    n_px = cfg.num_pixels
    full = pwf.render_wavefront(sc, isect, occl, cam,
                                RowSlices(3, n_px, slice(0, n_px)), 0, cfg)
    parts = []
    for r0, r1 in ((0, 6), (6, 16)):
        rows = slice(r0 * 16, r1 * 16)
        parts.append(pwf.render_wavefront(
            sc, isect, occl, cam, RowSlices(3, n_px, rows), 0, cfg,
            pixel_ids=torch.arange(rows.start, rows.stop)))
    for k in ("direct", "indirect", "specular", "depth", "normal",
              "albedo", "motion"):
        got = torch.cat([p[k] for p in parts])
        np.testing.assert_allclose(n(got), n(full[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    assert float(pwf.merge_channels(full).mean()) > 0.01


# -- the group ---------------------------------------------------------------

def test_distributed_initialize_is_a_noop_in_one_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    info = distributed.process_info()
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert set(info) == {"process_index", "process_count", "local_devices",
                         "global_devices"}
    assert not torch.distributed.is_initialized()


class _Mesh:
    """A stand-in 1-D mesh (rank, size) for checks made before any
    collective."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world

    def get_local_rank(self, axis):
        assert axis == shard.TILE_AXIS
        return self.rank

    def size(self):
        return self.world


def test_rows_seeds_and_refusals():
    assert shard.row_range(16, _Mesh(1, 4)) == (4, 8)
    assert n(shard.pixel_ids(3, 4, _Mesh(1, 2), device="cpu")).tolist() == \
        list(range(6, 12))
    with pytest.raises(ValueError):
        shard.row_range(10, _Mesh(0, 4))
    assert prenderer.rank_seed(5, 0) == 5
    seeds = {prenderer.rank_seed(5, r) for r in range(4)}
    assert len(seeds) == 4 and prenderer.rank_seed(5, 2) == \
        prenderer.rank_seed(5, 2)
    sc = presets.cornell_box()[0].build()
    cfg = pwf.RenderConfig(width=8, height=6)
    with pytest.raises(ValueError):      # 6 rows over 4 ranks
        prenderer.Renderer(sc, cfg, device="cpu", mesh=_Mesh(0, 4))
    with pytest.raises(ValueError):      # dynamic + mesh needs tiled
        prenderer.Renderer(sc, cfg, accel="brute", device="cpu",
                           mesh=_Mesh(0, 2), dynamic=object())


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_renderer_matches_single_device(world, tmp_path_factory):
    ranks, _ = _ranks(world, tmp_path_factory)
    got, ref = ranks[0]["render_mesh"], ranks[0]["render_plain"]
    assert int(ranks[0]["render_local_rows"]) == 16 * 16 // world
    assert got.shape == (16, 16, 3) and np.isfinite(got).all()
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["render_mesh"], got)   # gathered
    assert abs(got.mean() - ref.mean()) / ref.mean() < 0.03, (
        got.mean(), ref.mean())
    assert np.abs(got - ref).mean() < 0.15 * ref.mean()


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_restir_is_finite_and_lit(world, tmp_path_factory):
    ranks, _ = _ranks(world, tmp_path_factory)
    img = ranks[0]["restir_image"]
    assert img.shape == (256, 3) and np.isfinite(img).all()
    assert img.mean() > 1e-3 and bool(ranks[0]["restir_valid"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_train_step_matches_one_process(world, tmp_path_factory):
    ranks, _ = _ranks(world, tmp_path_factory)
    one = ranks[0]
    for r in ranks:
        np.testing.assert_allclose(r["train_mesh_loss"], one["train_one_loss"],
                                   rtol=1e-4)
        for k in ("base_color", "roughness", "metallic", "emissive",
                  "env_radiance"):
            np.testing.assert_allclose(r[f"train_mesh_grad_{k}"],
                                       one[f"train_one_grad_{k}"],
                                       rtol=1e-4, atol=1e-9, err_msg=k)
            np.testing.assert_array_equal(r[f"train_mesh_param_{k}"],
                                          ranks[0][f"train_mesh_param_{k}"])
    assert np.abs(one["train_one_grad_emissive"]).max() > 0


def test_halo_matches_jax_shard_map(tmp_path_factory):
    ranks, ref = _ranks(HALO_RANKS, tmp_path_factory)
    rows = HALO_W * HALO_H // HALO_RANKS
    for r, res in enumerate(ranks):
        sl = slice(r * rows, (r + 1) * rows)
        for variant in ("halo", "clamp"):
            np.testing.assert_array_equal(res[f"halo_{variant}_light_idx"],
                                          ref[variant]["light_idx"][sl])
            for f in FIELDS[1:]:
                np.testing.assert_allclose(
                    res[f"halo_{variant}_{f}"], ref[variant][f][sl],
                    rtol=1e-5, atol=1e-7, err_msg=f"{variant} {f} rank {r}")


def test_halo_fixes_the_seam_bias(tmp_path_factory):
    ranks, ref = _ranks(HALO_RANKS, tmp_path_factory)

    def row_means(w_sum):
        return w_sum.reshape(HALO_H, HALO_W).mean(1)

    got = {v: np.concatenate([r[f"halo_{v}_w_sum"] for r in ranks])
           for v in ("halo", "clamp")}
    full = row_means(ref["full"]["w_sum"])
    hl = HALO_H // HALO_RANKS
    seam = [hl - 1, hl, 2 * hl - 1, 2 * hl, 3 * hl - 1, 3 * hl]
    err = {v: np.abs(row_means(got[v])[seam] / full[seam] - 1.0)
           for v in got}
    assert err["halo"].max() < 0.05, err
    assert err["clamp"].max() > 2 * err["halo"].max(), err


# -- the CLI -----------------------------------------------------------------

def _cli_cmd(out, *flags):
    return [sys.executable, "-m", "lumenrenderer_tpu_torch.app.cli",
            "--preset", "cornell", "--size", "16x16", "--out-size", "16x16",
            "--spp", "2", "--depth", "2", "--cpu", "-o", str(out), *flags]


def test_cli_mesh_in_one_process_equals_the_plain_cli(tmp_path):
    rcs, outs = _spawn([_cli_cmd(tmp_path / "plain.png"),
                        _cli_cmd(tmp_path / "mesh.png", "--mesh")],
                       REPO, [_env()] * 2)
    assert rcs == [0, 0], outs
    assert "mesh:" in outs[1]
    assert (tmp_path / "plain.png").read_bytes() == \
        (tmp_path / "mesh.png").read_bytes()


def test_cli_two_ranks_mesh_and_distributed(tmp_path):
    port = shard.free_port()
    envs = [dict(_env(), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                 WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r))
            for r in range(2)]
    rcs, outs = _spawn([_cli_cmd(tmp_path / "out.png", "--mesh",
                                 "--distributed", "--aovs")] * 2, REPO, envs)
    assert rcs == [0, 0], outs
    assert "'process_count': 2" in outs[0] and "wrote" in outs[0]
    assert "wrote" not in outs[1]            # rank 0 writes
    assert (tmp_path / "out.png").exists()
    assert (tmp_path / "out.depth.png").exists()
