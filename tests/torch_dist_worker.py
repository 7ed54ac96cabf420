"""One rank of the port's multi-process CPU tests (``tests/test_torch_distributed.py``).

    python tests/torch_dist_worker.py SPEC.json RANK

SPEC names the world size, the rendezvous port and what to run:

* ``"step"``: one train step of the tiny model (state dict ``weights``) on
  this rank's rows of the global batch ``batch`` (npz) with the global re-id
  draws ``draws``; writes the metrics, the gradients, the parameters and
  the BatchNorm buffers after the step to ``out`` + ``.RANK.pt``;
* ``"main"``: ``scripts/main_torch.py --distributed --device cpu`` with
  ``argv``.

The process group is gloo on the CPU with a short timeout, so a hung rank
fails instead of waiting.
"""

import datetime
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from pctrans_torch.parallel import mesh  # noqa: E402


def run_step(spec):
    from pctrans_torch.config import ModelConfig, load_cfg
    from pctrans_torch.engine.solver import (build_lr_scheduler, build_optimizer,
                                             build_solver_config)
    from pctrans_torch.engine.train_step import make_train_step
    from pctrans_torch.losses.criterion import CriterionConfig, SetCriterion
    from pctrans_torch.models import PCTransModel

    model = PCTransModel(ModelConfig(**spec["model"]))
    model.load_state_dict(torch.load(spec["weights"], weights_only=True))
    solver = build_solver_config(load_cfg(opts=spec["solver_opts"]))
    opt = build_optimizer(model, solver)
    step = make_train_step(model, SetCriterion(CriterionConfig(**spec["criterion"])), opt,
                           build_lr_scheduler(opt, solver), spec["max_instances"])
    batch = dict(np.load(spec["batch"]))
    rows = len(batch["image"]) // mesh.world_size()
    mine = {k: v[mesh.rank() * rows:(mesh.rank() + 1) * rows] for k, v in batch.items()}
    metrics = step(mine, reid_uniform=torch.from_numpy(np.load(spec["draws"])))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()}}


def main():
    spec = json.loads(Path(sys.argv[1]).read_text())
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(spec["port"]),
                      WORLD_SIZE=str(spec["world"]), RANK=str(rank), LOCAL_RANK="0")
    if spec["kind"] == "main":
        import main_torch

        main_torch.main(["--distributed", "--device", "cpu", *spec["argv"]])
    else:
        mesh.initialize_distributed("gloo", "cpu",
                                    timeout=datetime.timedelta(seconds=spec["timeout"]))
        torch.save(run_step(spec), f"{spec['out']}.{rank}.pt")
    mesh.destroy()


if __name__ == "__main__":
    main()
