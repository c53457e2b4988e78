"""One gloo rank of the data-parallel tests in ``test_torch_parallel.py``
and ``test_torch_mesh_eval.py``.

    python tests/torch_dist_worker.py <spec.json> <rank>

Joins a ``file://`` store, builds the port's ``Trainer`` on a
('data', 'fsdp') mesh and restores the checkpoint ``spec["restore"]``.
Then, by ``spec["mode"]``:

- ``"step"`` (the default): writes, from rank 0, what the test compares:
  the restored state gathered whole, the validation metrics, and after one
  train step on this rank's rows of the global batch (given the global t
  and noise) the gathered state, the sampler buffers and the metrics; every
  rank writes its own state bytes. Then every rank saves the checkpoint.
- ``"eval"``: every rank validates (``spec["val_batches"]`` batches) and
  writes its metrics; with ``spec["train_seed"]`` it then takes one train
  step on its rows of the global batch, t and noise drawn from a generator
  seeded so, and rank 0 writes the state and the metrics; with
  ``spec["predict"]`` every rank predicts the test split into
  ``out/pred`` on the grids of ``spec["gt_root"]`` (rank 0 writes the
  volumes and the report) and rank 0 writes the report's rows. Each rank also writes the row count of every
  call of the trainer's ``sample_fn``.

Imports no JAX.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dsdiff_torch.parallel import dist as pdist  # noqa: E402
from dsdiff_torch.parallel.mesh import make_mesh  # noqa: E402
from dsdiff_torch.train.checkpoints import CheckpointManager  # noqa: E402
from dsdiff_torch.train.trainer import Trainer  # noqa: E402


def main(spec_path: str, rank: int) -> None:
    spec = json.loads(Path(spec_path).read_text())
    torch.set_num_threads(1)
    out = Path(spec["out"])
    pdist.initialize(f"file://{spec['store']}", spec["world"], rank,
                     backend="gloo")
    if not spec.get("gather", True):  # the variant the test must reject
        pdist.gather_rows = lambda x, dim=0: x
    mesh = make_mesh(spec["n_data"], spec["n_fsdp"])
    gathered = pdist.all_gather_host(np.array([rank, 2 * rank]))
    assert gathered.tolist() == [[r, 2 * r] for r in range(spec["world"])]
    pdist.sync_hosts()
    trainer = Trainer(spec["cfg"], out / "run", device="cpu", mesh=mesh)
    trainer.state, trainer.sampler_state = CheckpointManager(
        spec["restore"]).restore(trainer.state, trainer.sampler_state)
    if spec.get("mode") == "eval":
        evaluate(trainer, spec, rank, mesh)
        torch.distributed.destroy_process_group()
        return
    restored = trainer.state.state_dict()
    if rank == 0:
        torch.save(restored, out / "restored.pt")
    if spec.get("validate"):
        vm = trainer.validate(max_batches=1)
        if rank == 0:
            (out / "val.json").write_text(json.dumps(vm))
    data = np.load(spec["batch"])
    lo, hi = mesh.local_rows(data["target"].shape[0])
    batch = {k: torch.from_numpy(data[k][lo:hi]) for k in ("image", "target")}
    metrics = trainer.train_step(batch, t=torch.from_numpy(data["t"]),
                                 noise=torch.from_numpy(data["noise"]))
    after = trainer.state.state_dict()
    (out / f"bytes_{rank}.json").write_text(json.dumps(
        trainer.state.local_nbytes()))
    if rank == 0:
        torch.save({"state": after,
                    "loss_history": trainer.sampler_state.loss_history,
                    "loss_counts": trainer.sampler_state.loss_counts,
                    "metrics": {k: float(v) for k, v in metrics.items()}},
                   out / "after.pt")
    trainer.ckpt.save(trainer.state.step, trainer.state, trainer.sampler_state)
    torch.distributed.destroy_process_group()


def evaluate(trainer, spec: dict, rank: int, mesh) -> None:
    out = Path(spec["out"])
    rows_seen = []
    sample_fn = trainer.sample_fn

    def counted(cond, *args, **kw):
        rows_seen.append(int(cond.shape[0]))
        return sample_fn(cond, *args, **kw)

    trainer.sample_fn = counted
    val = trainer.validate(max_batches=spec["val_batches"])
    (out / f"val_{rank}.json").write_text(json.dumps(val))
    if spec.get("train_seed") is not None:
        data = np.load(spec["batch"])
        lo, hi = mesh.local_rows(data["target"].shape[0])
        batch = {k: torch.from_numpy(data[k][lo:hi])
                 for k in ("image", "target")}
        gen = torch.Generator().manual_seed(spec["train_seed"])
        metrics = trainer.train_step(batch, gen)
        if rank == 0:
            torch.save({"state": trainer.state.state_dict(),
                        "metrics": {k: float(v) for k, v in metrics.items()}},
                       out / "after.pt")
    if spec.get("predict"):
        _, rows = trainer.predict(out / "pred", template_root=spec["gt_root"],
                                  gt_root=spec["gt_root"],
                                  gt_name=spec["gt_name"])
        if rank == 0:
            (out / "rows.json").write_text(json.dumps(rows))
    (out / f"sampled_{rank}.json").write_text(json.dumps(rows_seen))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
