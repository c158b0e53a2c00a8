"""The command line of the port, reference-compatible:

    python -m lushnerf_torch.run --config configs/poster
    python -m lushnerf_torch.run --config configs/poster --render_only [--render_test]
    python -m lushnerf_torch.run --config configs/poster --save_warped_ray_img

Accepts the reference's flags and scene-config files verbatim
(run_lushnerf.py:32-229), as lushnerf_tpu's run_lushnerf_tpu.py does.
Trains on the GPU; it resumes from the latest checkpoint in
<basedir>/<expname> unless --no_reload.  From noisenerf_start_iter on
(60000 in the shipped scene configs) each iteration adds the CTE pass;
the matcher is cfg.matcher (`dkm` reads its weights from --dkm_ckpt_path
or $LUSHNERF_DKM_CKPT, and without them trains on match_table_path's
tables, or on zero tables, which give zero CTE loss).

On N cards of a host, one process per card, data-parallel
(`lushnerf_torch.parallel`):

    torchrun --nproc_per_node=N -m lushnerf_torch.run --config configs/poster

or, without torchrun, each process I of N (on any host) given the first's
address and its card:

    python -m lushnerf_torch.run --config configs/poster \
        --coordinator_address host0:29500 --num_processes N --process_id I \
        --local_device_ids I

Each rank trains on its stripe of the rays (N_rand / N a step) and the
grads are all-reduced every step; rank 0 writes the checkpoints, logs and
tables, and every rank resumes from rank 0's state.  A `mesh_shape` that
does not cover the N cards raises.  Without torchrun's environment or the
flags the run is one process on one card, as before.
"""

from __future__ import annotations

import sys

import torch.distributed

from lushnerf_torch.config import Config
from lushnerf_torch.parallel import distributed
from lushnerf_torch.train.trainer import Trainer


def main(argv=None, device="cuda"):
    """argv: the flags (sys.argv[1:] when None).  device: 'cuda', or 'cpu'
    when the caller asks for it (the tests; a process group then runs on
    gloo).  A process group this call brings up is taken down at its end."""
    cfg = Config.from_args(argv if argv is not None else sys.argv[1:])
    grouped = distributed.initialize(cfg.coordinator_address, cfg.num_processes,
                                     cfg.process_id, cfg.local_device_ids, device=device)
    try:
        trainer = Trainer(cfg, device=device)
        trainer.setup()
        if cfg.save_warped_ray_img:
            out = trainer.save_warped_ray_img()
            trainer._say("Warped rays and imgs are saved:", out)
            return out
        if cfg.render_only:
            out = trainer.render_only(render_test=cfg.render_test)
            trainer._say("RENDER ONLY done:", out)
            return out
        return trainer.train()
    finally:
        if grouped:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
