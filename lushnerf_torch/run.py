"""The command line of the port, reference-compatible:

    python -m lushnerf_torch.run --config configs/poster --N_iters 59999
    python -m lushnerf_torch.run --config configs/poster --render_only [--render_test]
    python -m lushnerf_torch.run --config configs/poster --save_warped_ray_img

Accepts the reference's flags and scene-config files verbatim
(run_lushnerf.py:32-229), as lushnerf_tpu's run_lushnerf_tpu.py does.
Trains on the GPU; it resumes from the latest checkpoint in
<basedir>/<expname> unless --no_reload.  CTE is not ported yet, so a run
whose iterations reach noisenerf_start_iter (60000 in the shipped scene
configs) stops before training: pass --N_iters below it.
"""

from __future__ import annotations

import sys

from lushnerf_torch.config import Config
from lushnerf_torch.train.trainer import Trainer


def main(argv=None, device="cuda"):
    """argv: the flags (sys.argv[1:] when None).  device: 'cuda', or 'cpu'
    when the caller asks for it (the tests)."""
    cfg = Config.from_args(argv if argv is not None else sys.argv[1:])
    trainer = Trainer(cfg, device=device)
    trainer.setup()
    if cfg.save_warped_ray_img:
        out = trainer.save_warped_ray_img()
        print("Warped rays and imgs are saved:", out)
        return out
    if cfg.render_only:
        out = trainer.render_only(render_test=cfg.render_test)
        print("RENDER ONLY done:", out)
        return out
    return trainer.train()


if __name__ == "__main__":
    main()
