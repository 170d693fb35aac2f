"""Processes of the port's data-parallel tests on the CPU.

`spawn(task, out_dir)` (or `start`, then `finish`) runs `world` copies of
this file, one per rank, joined in a gloo group by file rendezvous in
`out_dir`; each runs `TASKS[task](mesh, shard, out_dir)` and saves what it
returns to `out_dir/<task>_<rank>.pt`, which `finish` loads and returns in
rank order.
Every process has a time limit; the workers import torch and the port only.

    python tests/_torch_dp.py TASK RANK WORLD OUT_DIR
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def start(task: str, out_dir: Path, world: int = 2):
    """Start the `world` processes of `task`; `finish` collects them."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, __file__, task, str(r), str(world), str(out_dir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]


def finish(procs, task: str, out_dir: Path, timeout: float = 300.0):
    """Wait for `procs` (killing any still running after `timeout` seconds)
    and return each rank's result."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {task!r}:\n{out[-4000:]}"
    return [torch.load(out_dir / f"{task}_{r}.pt", weights_only=False)
            for r in range(len(procs))]


def spawn(task: str, out_dir: Path, world: int = 2, timeout: float = 300.0):
    return finish(start(task, out_dir, world), task, out_dir, timeout)


# ------------------------------------------------------------- the world
def world_and_episodes(cfg, batch: int, world_seed: int = 1, ep_seed: int = 2,
                       world_fn=None, episodes_fn=None):
    """The tiny synthetic world and `batch` episodes (the port's generators,
    or the JAX package's when given: the same arrays)."""
    if world_fn is None:
        from vln_imagine_tpu_torch.envx import (
            synthetic_episodes as episodes_fn,
        )
        from vln_imagine_tpu_torch.envx import synthetic_world as world_fn
    world, graphs = world_fn(
        num_scans=2, num_nodes=20, max_candidates=cfg.env.max_candidates,
        views=cfg.env.views, feat_dim=cfg.model.image_feat_size,
        seed=world_seed)
    ep = episodes_fn(
        world, batch=batch, max_gt_path_len=cfg.env.max_gt_path_len,
        max_instr_len=cfg.env.max_instr_len,
        max_imaginations=cfg.model.max_imagination_len,
        vocab_size=cfg.model.vocab_size, feat_dim=cfg.model.hidden_size,
        seed=ep_seed)
    return world, graphs, ep


def with_(cfg, part, **kw):
    return dataclasses.replace(
        cfg, **{part: dataclasses.replace(getattr(cfg, part), **kw)})


def teacher_config(agent: str, aux: str = "cosine", tiny=None):
    """The f32 tiny config of the steps held against the JAX package's:
    every configurable dropout 0, and every parameter group training from
    the first step (stage ends 0)."""
    if tiny is None:
        from vln_imagine_tpu_torch.config import tiny_test_config as tiny
    cfg = with_(tiny(agent), "train", warmup_stage1_iters=0,
                warmup_stage2_iters=0,
                train_alg="imitation" if agent == "duet" else "sample")
    return with_(cfg, "model", aux_loss_type=aux)


def dropout_config(agent: str, **train):
    """The tiny config with every dropout on (the draws a rank must take
    from the global batch's stream)."""
    from vln_imagine_tpu_torch.config import tiny_test_config

    cfg = with_(tiny_test_config(agent), "model", hidden_dropout_prob=0.1,
                attention_probs_dropout_prob=0.1, pred_head_dropout_prob=0.1)
    return with_(cfg, "train", feat_dropout=0.4, warmup_stage1_iters=0,
                 warmup_stage2_iters=0, **train)


def trainer(agent: str, cfg, world, mesh=None, state_dict=None, seed=None):
    from vln_imagine_tpu_torch.train.trainer import HamtTrainer
    from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

    cls = HamtTrainer if agent == "hamt" else DuetTrainer
    tr = cls(cfg, world, device="cpu", mesh=mesh, seed=seed)
    if state_dict is not None:
        # the alignment head's fixed dropout is taken out of both packages
        tr.model.contrastive_alignment_model.image_proj.rate = 0.0
        tr.model.load_state_dict(state_dict, strict=True)
    return tr


def train_step(tr, ep_il, ep_rl, feedback: str) -> dict:
    """One step (HAMT under `feedback`, DUET under its train_alg); the
    metrics as floats and the updated state dicts."""
    step = (tr.make_train_step(feedback) if tr.cfg.agent == "hamt"
            else tr.make_train_step())
    m = step(ep_il, ep_rl)
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "model": {k: v.clone() for k, v in tr.model.state_dict().items()}}
    if getattr(tr, "critic", None) is not None:
        out["critic"] = {k: v.clone() for k, v in tr.critic.state_dict().items()}
    return out


# "teacher" steps against the JAX package (from its init), then the dropout
# steps against the port's one-process step (from the seeded init)
TEACHER_CASES = [("hamt", "cosine"), ("hamt", "infonce"), ("hamt", "margin"),
                 ("duet", "cosine")]
# case -> (agent, train overrides); the fused rollout's batch is the IL and
# the RL batch side by side, two global batches whose rows a rank draws
DROPOUT_CASES = {"hamt_dropout": ("hamt", {}), "duet_dropout": ("duet", {}),
                 "hamt_fused": ("hamt", {"fused_sample_rollout": True})}
TRAIN_BATCH = 4


def train_cases(mesh, out_dir: Path, shard_fn=lambda ep: ep):
    """Every train case on `mesh` (None: one process); the episodes are
    `shard_fn` of the global batch."""
    out = {}
    for agent, aux in TEACHER_CASES:
        cfg = teacher_config(agent, aux)
        world, _, ep = world_and_episodes(cfg, TRAIN_BATCH)
        sd = torch.load(out_dir / f"{agent}_init.pt")
        tr = trainer(agent, cfg, world, mesh, sd)
        out[f"{agent}_{aux}"] = train_step(tr, shard_fn(ep), shard_fn(ep),
                                           "teacher")
    for case, (agent, train) in DROPOUT_CASES.items():
        cfg = dropout_config(agent, **train)
        world, _, ep = world_and_episodes(cfg, TRAIN_BATCH)
        _, _, ep2 = world_and_episodes(cfg, TRAIN_BATCH, ep_seed=3)
        tr = trainer(agent, cfg, world, mesh, seed=5)
        out[case] = train_step(tr, shard_fn(ep), shard_fn(ep2), "sample")
    return out


# -------------------------------------------------------------- the tasks
def task_collectives(mesh, shard, out_dir):
    from vln_imagine_tpu_torch.parallel.distributed import (
        all_gather_objects,
        is_default_process,
        merge_results,
        reduce_dict,
        shard_indices,
    )

    pid = shard.rank
    # unequal payload sizes force the size exchange and the padding
    mine = {"rank": pid, "preds": [{"instr_id": f"i{pid}_{j}", "v": j}
                                   for j in range(2 + 3 * pid)]}
    gathered = all_gather_objects(mine)
    sl = shard_indices(10)
    return {
        "default": is_default_process(),
        "ranks": [g["rank"] for g in gathered],
        "n_preds": [len(g["preds"]) for g in gathered],
        "reduced": reduce_dict({"loss": 1.0 + pid, "n": 10.0 * (pid + 1)}),
        "summed": reduce_dict({"loss": 1.0 + pid}, average=False),
        "shard": [sl.start, sl.stop],
        "merged_ids": sorted(m["instr_id"] for m in merge_results(
            [g["preds"] for g in gathered])),
    }


def task_mesh_eval(mesh, shard, out_dir):
    from vln_imagine_tpu_torch.parallel.mesh import make_mesh, shard_batch

    errors = {}
    for name, kw in (("model", dict(data=1, model=2)), ("shape", dict(data=3))):
        try:
            make_mesh(**kw)
        except (NotImplementedError, ValueError) as e:
            errors[name] = f"{type(e).__name__}: {e}"
    out = {"errors": errors,
           "rows": shard_batch({"a": np.arange(8), "b": torch.arange(6),
                                "s": 3}, mesh),
           "mesh": (tuple(mesh.mesh_dim_names), tuple(mesh.shape))}
    out.update(eval_cases(mesh, out_dir, lambda ep: shard_batch(ep, mesh)))
    return out


EVAL_BATCH = 8


def eval_cases(mesh, out_dir: Path, shard_fn=lambda ep: ep):
    """Greedy paths of HAMT from the JAX init and of DUET from the seeded
    init, on `mesh` (None: one process)."""
    from vln_imagine_tpu_torch.config import tiny_test_config

    out = {}
    for agent in ("hamt", "duet"):
        cfg = tiny_test_config(agent)
        world, _, ep = world_and_episodes(cfg, EVAL_BATCH, world_seed=0,
                                          ep_seed=1)
        sd = (torch.load(out_dir / "hamt_eval_init.pt") if agent == "hamt"
              else None)
        tr = trainer(agent, cfg, world, mesh, sd, seed=7)
        paths, lens = tr.make_eval_step()(shard_fn(ep))[:2]
        out[agent] = (paths.numpy(), lens.numpy())
    return out


def task_train(mesh, shard, out_dir):
    from vln_imagine_tpu_torch.parallel.mesh import shard_batch

    return train_cases(mesh, out_dir, lambda ep: shard_batch(ep, mesh))


def driver_splits(cfg):
    from vln_imagine_tpu_torch.driver import SplitData

    world, graphs, train = world_and_episodes(cfg, 8, world_seed=0, ep_seed=1)
    _, _, val = world_and_episodes(cfg, 6, world_seed=0, ep_seed=2)
    return world, graphs, SplitData("train", train,
                                    [f"train_{i}" for i in range(8)]), \
        SplitData("val_unseen", val, [f"val_unseen_{i}" for i in range(6)])


def driver_config():
    from vln_imagine_tpu_torch.config import tiny_test_config

    return with_(tiny_test_config("hamt"), "train", batch_size=4)


def run_driver(log_dir: Path, mesh=None):
    """validate, two intervals, validate with the files, then one interval
    that a fault on the last rank rolls back; what each step left."""
    from vln_imagine_tpu_torch.driver import FinetuneDriver
    from vln_imagine_tpu_torch.parallel.distributed import process_count

    cfg = driver_config()
    world, graphs, train, val = driver_splits(cfg)
    d = FinetuneDriver(cfg, world, train, [val], str(log_dir), graphs=graphs,
                       device="cpu", mesh=mesh)
    saves = []
    for kind in ("save_latest", "save_snapshot", "maybe_save_best"):
        orig = getattr(d.ckpt, kind)

        def counted(*a, _orig=orig, _kind=kind, **k):
            saves.append(_kind)
            return _orig(*a, **k)
        setattr(d.ckpt, kind, counted)
    d.setup()
    out = {"score0": d.validate(val)}
    d.run(iters=2, log_every=1)
    out["score2"] = d.validate(val, write_outputs=True)
    out["trained"] = {k: v.clone() for k, v in d.trainer.model.state_dict().items()}
    rank = d.shard.rank if d.shard is not None else 0
    orig_interval = d.train_interval

    def faulty(n):
        logs = orig_interval(n)
        if rank == process_count() - 1:
            raise RuntimeError("injected fault")
        return logs
    d.train_interval = faulty
    d.run(iters=1, log_every=1)
    out["after_rollback"] = {k: v.clone()
                             for k, v in d.trainer.model.state_dict().items()}
    out["saves"] = saves
    return out


def task_driver(mesh, shard, out_dir):
    return run_driver(out_dir / "run", mesh)


TASKS = {"collectives": task_collectives, "mesh_eval": task_mesh_eval,
         "train": task_train, "driver": task_driver}


def main(task: str, rank: int, world: int, out_dir: Path) -> None:
    torch.set_num_threads(1)
    from vln_imagine_tpu_torch.parallel.distributed import initialize
    from vln_imagine_tpu_torch.parallel.mesh import DataShard, make_mesh

    initialize(f"file://{out_dir / f'{task}_rdzv'}", world, rank,
               device="cpu", timeout=120)
    mesh = make_mesh(data=world)
    out = TASKS[task](mesh, DataShard.of(mesh), out_dir)
    torch.save(out, out_dir / f"{task}_{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
