"""One rank of a gloo process group for tests/test_torch_parallel.py.

Run: python tests/_torch_dist_worker.py RANK WORLD PORT IN.npz OUT.npz

Imports torch and the port only. Each rank joins the group on localhost,
makes the 1-D mesh and runs, on the CPU:
- render: the mesh Renderer on the 16x16 Cornell box at 48 spp
  (tests/test_parallel.py:120's setup), the gathered image; rank 0 also
  the plain Renderer's;
- restir: two ReSTIR frames under the mesh (tests/test_parallel.py:168);
- halo: when IN.npz holds its inputs, spatial_pass on this rank's rows
  with the halo and clamped at the rank's edges, each with the draws given;
- train: the sharded training step with the brute-force accel and the
  full frame's draws sliced to this rank's rows; rank 0 also the
  one-process step with the full draws.
It writes its results to OUT.npz.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from lumenrenderer_tpu_torch.accel import brute  # noqa: E402
from lumenrenderer_tpu_torch.integrator.wavefront import RenderConfig  # noqa: E402
from lumenrenderer_tpu_torch.parallel import shard, train  # noqa: E402
from lumenrenderer_tpu_torch.render.renderer import Renderer  # noqa: E402
from lumenrenderer_tpu_torch.restir import di  # noqa: E402
from lumenrenderer_tpu_torch.scene import presets  # noqa: E402

RENDER_SPP = 48
TRAIN_SEED = 11


class RowSlices:
    """A draw source from numpy's generator of `seed`: each call draws the
    whole frame's (n_full, *rest) uniforms and returns the rows `rows`."""

    def __init__(self, seed: int, n_full: int, rows: slice):
        self.g = np.random.default_rng(seed)
        self.n_full = n_full
        self.rows = rows

    def __call__(self, *shape):
        n = self.rows.stop - self.rows.start
        assert shape[0] == n, (shape, n)
        full = self.g.random((self.n_full,) + tuple(shape[1:]),
                             dtype=np.float32)
        return torch.from_numpy(full[self.rows].copy())

    uniform = __call__


class ListDraws:
    """Given arrays, in order, each checked against the shape drawn."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def uniform(self, *shape):
        a = self.arrays.pop(0)
        assert a.shape == shape, (a.shape, shape)
        return torch.from_numpy(np.array(a, np.float32))

    __call__ = uniform


def _cornell():
    b, camf = presets.cornell_box(with_blocks=True)
    return b.build(), camf(1.0)


def check_render(mesh, rank, out):
    sc, cam = _cornell()
    cfg = RenderConfig(width=16, height=16, max_depth=3, bsdf="lambert",
                       light_strategy="mis", rr_start_depth=99,
                       sort_secondary=False)
    r = Renderer(sc, cfg, accel="tiled", device="cpu", mesh=mesh)
    st = r.init_state(0)
    out["render_local_rows"] = np.int64(st.accum.shape[0])
    out["render_mesh"] = r.render(cam, spp=RENDER_SPP)
    if rank == 0:
        out["render_plain"] = Renderer(sc, cfg, accel="tiled",
                                       device="cpu").render(cam,
                                                            spp=RENDER_SPP)


def check_restir(mesh, out):
    sc, cam = _cornell()
    cfg = RenderConfig(width=16, height=16, max_depth=2, bsdf="lambert",
                       light_strategy="nee", rr_start_depth=99,
                       use_restir=True, sort_secondary=False)
    rcfg = di.RestirConfig(num_bags=4, bag_size=16, candidates=4,
                           spatial_samples=2, spatial_iterations=1)
    r = Renderer(sc, cfg, accel="tiled", device="cpu", restir_config=rcfg,
                 mesh=mesh)
    st = r.init_state(0)
    for _ in range(2):
        st, _ = r.render_frame(st, cam)
    out["restir_image"] = r.full_frame(st.accum).numpy()
    out["restir_valid"] = np.bool_(st.restir.valid)


def check_halo(mesh, rank, world, inp, out):
    import types

    w, h = int(inp["halo_w"]), int(inp["halo_h"])
    hl = h // world
    rows = slice(rank * hl * w, (rank + 1) * hl * w)
    sc, _ = _cornell()
    cfg = di.RestirConfig(spatial_samples=8, spatial_radius=8,
                          spatial_iterations=1, biased=True)
    sd = types.SimpleNamespace(
        position=torch.from_numpy(inp["halo_position"][rows]),
        normal=torch.from_numpy(inp["halo_normal"][rows]),
        base_color=torch.from_numpy(inp["halo_base_color"][rows]))
    hit = torch.from_numpy(inp["halo_hit"][rows])
    res = di.Reservoir(**{f: torch.from_numpy(inp[f"halo_res_{f}"][rows])
                          for f in ("light_idx", "bary", "w_sum", "m",
                                    "w_out", "p_hat")})
    for variant, halo in (("halo", mesh), ("clamp", None)):
        draws = ListDraws([inp[f"halo_draws_{variant}_{i}"]
                           for i in range(3)])
        got = di.spatial_pass(sc, sd, res, hit, cfg, w, hl, draws,
                              halo=halo)
        for f in ("light_idx", "bary", "w_sum", "m", "w_out", "p_hat"):
            out[f"halo_{variant}_{f}"] = getattr(got, f).numpy()


def train_setup():
    sc, cam = _cornell()
    cfg = RenderConfig(width=16, height=16, max_depth=3, bsdf="lambert",
                       light_strategy="mis", rr_start_depth=99)
    tri = sc.tri_pos

    def isect(o, d, tn, tx):
        return dict(brute.intersect_closest(tri, o, d, tn, tx),
                    overflow=torch.tensor(False))

    def occl(o, d, tn, tx):
        return brute.intersect_any(tri, o, d, tn, tx)

    target = torch.zeros((cfg.num_pixels, 3))
    return sc, cam, cfg, isect, occl, target


def _step_results(state, loss, prefix, out):
    out[f"{prefix}_loss"] = np.float32(loss)
    for k, p in state.params.items():
        out[f"{prefix}_grad_{k}"] = p.grad.numpy()
        out[f"{prefix}_param_{k}"] = p.detach().numpy()


def check_train(mesh, rank, world, out):
    sc, cam, cfg, isect, occl, target = train_setup()

    def sgd(ps):
        return torch.optim.SGD(ps.values(), lr=1e-2)

    n = cfg.num_pixels
    rows = slice(rank * n // world, (rank + 1) * n // world)
    init, step = train.make_sharded_train_step(sc, isect, occl, cam, cfg,
                                               sgd, mesh)
    state, loss = step(init(), RowSlices(TRAIN_SEED, n, rows), 0, target)
    _step_results(state, loss, "train_mesh", out)
    if rank == 0:
        init1, step1 = train.make_train_step(sc, isect, occl, cam, cfg, sgd)
        state1, loss1 = step1(init1(), RowSlices(TRAIN_SEED, n, slice(0, n)),
                              0, target)
        _step_results(state1, loss1, "train_one", out)


def main():
    rank, world, port = (int(x) for x in sys.argv[1:4])
    inp = dict(np.load(sys.argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    mesh = shard.make_mesh("cpu")
    out = {"rank": np.int64(shard.rank_and_size(mesh)[0]),
           "world": np.int64(mesh.size())}
    check_render(mesh, rank, out)
    check_restir(mesh, out)
    if "halo_w" in inp:
        check_halo(mesh, rank, world, inp, out)
    check_train(mesh, rank, world, out)
    np.savez(sys.argv[5], **out)
    dist.destroy_process_group()
    print("RANK_OK", rank, flush=True)


if __name__ == "__main__":
    main()
