"""One rank of tests/test_torch_parallel.py's two-process runs: the port's
data-parallel training on the CPU under gloo, without JAX.

    python tests/torch_ddp_worker.py <spec.json> <rank>

The process group comes up from torchrun's environment (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT, set here from the spec) through
`lushnerf_torch.parallel.distributed.initialize`.  spec: the world, the
store's address and port, the scene (.npz) and its (H, W, focal); the
step's tiny config (keyword arguments), fixed global batch (.npz), initial
weights (a state dict) and stage; the loop's tiny config; the output
directory.  The rank:
  1. takes one `train_step` on its stripe [rank::world] of the global
     batch, from the given weights, and keeps its params and grads;
  2. trains a `Trainer` (basedir <out>/rank<r>) across kernel_start_iter
     and noisenerf_start_iter with a content-keyed stub matcher, through a
     striped rematch and a striped eval, and keeps its first three batches,
     params, tables and metrics and the files it wrote; then the striped
     tables of the current renders beside the ones one process builds;
  3. builds a second `Trainer` on its basedir (rank 0's holds the
     checkpoint, rank 1's nothing), keeps what it resumed, trains on and
     keeps its params.
It writes <out>/rank<r>.pt for the test to compare.
"""

import copy
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class ContentStub:
    """Matches keyed on the two images' content, not on the call order:
    ranks that match different pairs agree only if the gather puts each
    pair back in its place."""

    def match(self, img0, img1):
        n = 12
        h, w = img0.shape[:2]
        seed = int(abs(float(img0.sum()) * 1e4 + float(img1.sum()) * 7.0)) % (2 ** 31)
        rng = np.random.default_rng(seed)
        k0 = np.stack([rng.uniform(0, w - 1, n), rng.uniform(0, h - 1, n)], -1).astype(np.float32)
        k1 = np.clip(k0 + rng.normal(0, 0.5, k0.shape), 0, w - 1).astype(np.float32)
        return k0, k1, rng.uniform(0.5, 1.0, n).astype(np.float32)


def state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def main(spec_path, rank):
    spec = json.load(open(spec_path))
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(spec["world"]),
                      MASTER_ADDR=spec["addr"], MASTER_PORT=str(spec["port"]))
    import torch

    torch.set_num_threads(2)
    from lushnerf_torch.config import Config
    from lushnerf_torch.matcher.api import build_match_tables
    from lushnerf_torch.models.lushnerf import LushNeRF
    from lushnerf_torch.parallel import distributed as dist
    from lushnerf_torch.train import trainer as tt

    assert dist.initialize(device="cpu")
    assert (dist.process_index(), dist.process_count()) == (rank, spec["world"])
    out = {}
    scene = dict(np.load(spec["scene"]))
    scene["hwf"] = tuple(spec["hwf"])

    # 1. one step on this rank's stripe of the global batch
    cfg = Config(**dict(spec["step_kwargs"], num_images=len(scene["images"])))
    lc = cfg.lush_config()
    model = LushNeRF(lc, device="cpu")
    model.load_state_dict(torch.load(spec["init"], weights_only=True), strict=True)
    opt, sched = tt.make_optimizer(cfg, model)
    batch = {k: torch.from_numpy(v[rank::spec["world"]]) for k, v in np.load(spec["batch"]).items()}
    loss, _ = tt.train_step(model, opt, sched, lc, *spec["hwf"], batch, spec["stage"],
                            torch.Generator().manual_seed(rank), grad_clip_norm=cfg.grad_clip_norm)
    out["step_loss"] = float(loss)
    out["step_params"] = state(model)
    out["step_grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}

    # 2. the loop across the CTE start: a striped rematch and a striped eval
    kw = dict(spec["loop_kwargs"], basedir=os.path.join(spec["out"], f"rank{rank}"))
    tr = tt.Trainer(Config(**kw), data=scene, matcher=ContentStub(), device="cpu")
    tr.setup()
    out["dataset_rays"], out["local_n_rand"] = len(tr.dataset), tr.local_n_rand
    ds, rng = copy.copy(tr.dataset), copy.deepcopy(tr.np_rng)  # the loop's draws untouched
    out["first_batches"] = [ds.next_batch(tr.local_n_rand, rng) for _ in range(3)]
    evals = []
    real_eval = tr.eval_testset
    tr.eval_testset = lambda i, save=True: evals.append(real_eval(i, save)) or evals[-1]
    out["train"] = tr.train()
    out["evals"] = evals
    out["params"] = state(tr.model)
    out["tables"] = (tr.match_tables.kpts, tr.match_tables.certainty)
    renders = tr._render_poses(tr.poses[tr.i_train])[0].numpy()
    striped = tr._build_tables_striped(renders)
    single = build_match_tables(tr._matcher, renders)
    out["striped_equals_single"] = bool(np.array_equal(striped.kpts, single.kpts)
                                        and np.array_equal(striped.certainty, single.certainty))
    out["files"] = sorted(os.path.relpath(os.path.join(d, f), kw["basedir"])
                          for d, _, fs in os.walk(kw["basedir"]) for f in fs)

    # 3. resume: rank 1's basedir is empty, rank 0's holds the checkpoint
    tr2 = tt.Trainer(Config(**kw), data=scene, matcher=ContentStub(), device="cpu")
    tr2.setup()
    out["resumed_step"] = tr2.start_step
    out["resumed_params_equal"] = all(torch.equal(v, out["params"][k])
                                      for k, v in tr2.model.state_dict().items())
    out["resumed_tables_equal"] = bool(np.array_equal(tr2.match_tables.kpts, out["tables"][0]))
    out["resumed_lr"] = tr2.optimizer.param_groups[0]["lr"]
    tr2.train(kw["N_iters"] + 2)
    out["resumed_params"] = state(tr2.model)
    out["jax_imported"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "lushnerf_tpu"))
    torch.save(out, os.path.join(spec["out"], f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
