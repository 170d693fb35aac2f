"""Processes of the port's data- and tensor-parallel tests on the CPU.

`spawn(task, out_dir)` (or `start`, then `finish`) runs `world` copies of
this file, one per rank, joined in a gloo group by file rendezvous in
`out_dir` on a mesh of `world // model` x `model`; each runs
`TASKS[task](mesh, shard, out_dir)` and saves what it returns to
`out_dir/<task>_<rank>.pt`, which `finish` loads and returns in rank order.
Under a model axis the workers split every parameter of at least
`TP_MIN_SIZE` elements (the JAX package's mesh test's `min_size`), so that
the tiny configs have split parameters.
Every process has a time limit; the workers import torch and the port only.

    python tests/_torch_dp.py TASK RANK WORLD OUT_DIR [MODEL]

Under a launcher (`torch.distributed.run`), `python tests/_torch_dp.py cli
ARGS...` runs the train CLI with ARGS at `TP_MIN_SIZE`.
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
TP_MIN_SIZE = 2 ** 10


def start(task: str, out_dir: Path, world: int = 2, model: int = 1):
    """Start the `world` processes of `task` on a mesh whose model axis
    is `model`; `finish` collects them."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, __file__, task, str(r), str(world), str(out_dir),
         str(model)],
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


def spawn(task: str, out_dir: Path, world: int = 2, timeout: float = 300.0,
          model: int = 1):
    return finish(start(task, out_dir, world, model), task, out_dir, timeout)


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
        from vln_imagine_tpu_torch.parallel.tensor import load_sharded

        # the alignment head's fixed dropout is taken out of both packages
        tr.model.contrastive_alignment_model.image_proj.rate = 0.0
        load_sharded(tr.model, state_dict)
    return tr


def whole_state(module) -> dict:
    """A copy of `module`'s state_dict with whole tensors (gathered over
    the model axis where split)."""
    from vln_imagine_tpu_torch.parallel.tensor import gather_state

    return {k: v.clone() for k, v in gather_state(module).items()}


def train_step(tr, ep_il, ep_rl, feedback: str) -> dict:
    """One step (HAMT under `feedback`, DUET under its train_alg); the
    metrics as floats and the updated (whole) state dicts."""
    step = (tr.make_train_step(feedback) if tr.cfg.agent == "hamt"
            else tr.make_train_step())
    m = step(ep_il, ep_rl)
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "model": whole_state(tr.model)}
    if getattr(tr, "critic", None) is not None:
        out["critic"] = whole_state(tr.critic)
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


def train_cases(mesh, out_dir: Path, shard_fn=lambda ep: ep,
                teacher: bool = True):
    """Every train case on `mesh` (None: one process), or without `teacher`
    the dropout cases only; the episodes are `shard_fn` of the global
    batch."""
    out = {}
    for agent, aux in TEACHER_CASES if teacher else ():
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
    from vln_imagine_tpu_torch.parallel.mesh import (
        DataShard,
        make_mesh,
        shard_batch,
    )
    from vln_imagine_tpu_torch.parallel.tensor import ModelShard

    errors = {}
    try:
        make_mesh(data=3)
    except ValueError as e:
        errors["shape"] = f"{type(e).__name__}: {e}"
    models = {}
    for data in (1, -1):  # a model axis over both processes
        m = make_mesh(data=data, model=2)
        ms, ds = ModelShard.of(m), DataShard.of(m)
        models[data] = (tuple(m.mesh_dim_names), tuple(m.shape),
                        (ms.rank, ms.size), (ds.rank, ds.size))
    out = {"errors": errors, "model_meshes": models,
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
    from vln_imagine_tpu_torch.parallel.distributed import (
        process_count,
        process_index,
    )

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
    out["trained"] = whole_state(d.trainer.model)
    rank = process_index()
    orig_interval = d.train_interval

    def faulty(n):
        logs = orig_interval(n)
        if rank == process_count() - 1:
            raise RuntimeError("injected fault")
        return logs
    d.train_interval = faulty
    d.run(iters=1, log_every=1)
    out["after_rollback"] = whole_state(d.trainer.model)
    out["saves"] = saves
    return out


def task_driver(mesh, shard, out_dir):
    return run_driver(out_dir / "run", mesh)


def reload_driver(log_dir: Path, mesh=None) -> dict:
    """A fresh driver on `mesh` that loads `log_dir`'s latest_dict: the
    whole state it reports, and this rank's parameters against the file's
    slices."""
    from vln_imagine_tpu_torch.driver import FinetuneDriver
    from vln_imagine_tpu_torch.parallel.tensor import split_of

    cfg = driver_config()
    world, graphs, train, val = driver_splits(cfg)
    d = FinetuneDriver(cfg, world, train, [val], str(log_dir / "fresh"),
                       graphs=graphs, device="cpu", mesh=mesh)
    d.setup()
    latest = log_dir / "ckpts" / "latest_dict"
    d.load_checkpoint(str(latest))
    saved = torch.load(latest, weights_only=True)
    want = saved["vln_bert"]["state_dict"]
    local = {}
    for name, p in d.trainer.model.named_parameters():
        sp = split_of(p)
        w = want[name] if sp is None else sp.local(want[name])
        local[name] = (torch.equal(p.detach(), w), sp is not None)
    return {"state": d.state_dict(), "saved": saved, "local": local}


def cfg_mesh_driver(log_dir: Path, data: int = 0, model: int = 1) -> dict:
    """The driver whose `cfg.mesh` asks for a mesh of `data` x `model`
    (none at data 0), which it builds itself: one train interval and
    `validate`."""
    from vln_imagine_tpu_torch.driver import FinetuneDriver
    from vln_imagine_tpu_torch.parallel.tensor import split_of

    cfg = with_(driver_config(), "mesh", data_parallelism=data,
                model_parallelism=model)
    world, graphs, train, val = driver_splits(cfg)
    d = FinetuneDriver(cfg, world, train, [val], str(log_dir), graphs=graphs,
                       device="cpu")
    d.setup()
    return {"mesh": None if d.mesh is None else tuple(d.mesh.shape),
            "split": sum(split_of(p) is not None
                         for p in d.trainer.model.parameters()),
            "logs": d.train_interval(1), "score": d.validate(val)}


def task_tp_cfg_driver(mesh, shard, out_dir):
    return cfg_mesh_driver(out_dir / "run", data=1, model=2)


def task_tp_driver(mesh, shard, out_dir):
    out = run_driver(out_dir / "run", mesh)
    out["reload"] = reload_driver(out_dir / "run", mesh)
    return out


# ------------------------------------------------------------ model axis
# hidden 48 over 3 heads: at a model axis of 2 a rank's columns are one
# and a half heads (q, k and v are gathered), at 3 one head a rank, and the
# critic's [48, 512] kernel is split on its input axis (512 % 3 != 0)
ODD_HEADS = dict(hidden_size=48, num_attention_heads=3, intermediate_size=96)


def odd_heads_config(agent: str, dropout: bool):
    from vln_imagine_tpu_torch.config import tiny_test_config

    cfg = dropout_config(agent) if dropout else tiny_test_config(agent)
    return with_(cfg, "model", **ODD_HEADS)


def first_logits(tr, ep) -> np.ndarray:
    """The greedy rollout's logits at its first step (this rank's rows)."""
    from vln_imagine_tpu_torch.train.rollout_duet import rollout_duet
    from vln_imagine_tpu_torch.train.rollout_hamt import rollout_hamt

    with torch.no_grad():
        if tr.cfg.agent == "hamt":
            res = rollout_hamt(tr.model, tr.tables, ep.to(tr.device), tr.cfg,
                               max_steps=2)
        else:
            res = rollout_duet(tr.model, tr.tables, ep.to(tr.device), tr.cfg,
                               max_steps=2, shard=tr.shard)
    return res.logits[0].numpy()


def tp_eval_cases(mesh, out_dir: Path, shard_fn=lambda ep: ep,
                  odd: bool = False) -> dict:
    """Greedy paths and first-step logits of both agents on `mesh` (None:
    one process): the tiny configs (HAMT from the JAX init, DUET seeded),
    or with `odd` the ODD_HEADS configs, seeded."""
    from vln_imagine_tpu_torch.config import tiny_test_config

    out = {}
    for agent in ("hamt", "duet"):
        cfg = odd_heads_config(agent, False) if odd else tiny_test_config(agent)
        world, _, ep = world_and_episodes(cfg, EVAL_BATCH, world_seed=0,
                                          ep_seed=1)
        sd = (torch.load(out_dir / "hamt_eval_init.pt")
              if agent == "hamt" and not odd else None)
        tr = trainer(agent, cfg, world, mesh, sd, seed=7)
        ep = shard_fn(ep)
        paths, lens = tr.make_eval_step()(ep)[:2]
        out[agent] = {"paths": paths.numpy(), "lens": lens.numpy(),
                      "logits": first_logits(tr, ep)}
    return out


def odd_train_cases(mesh, shard_fn=lambda ep: ep) -> dict:
    """The HAMT `sample` step (with its critic) and the DUET DAgger step of
    the ODD_HEADS configs with every dropout on, from the seeded init."""
    out = {}
    for agent in ("hamt", "duet"):
        cfg = odd_heads_config(agent, True)
        world, _, ep = world_and_episodes(cfg, TRAIN_BATCH)
        _, _, ep2 = world_and_episodes(cfg, TRAIN_BATCH, ep_seed=3)
        tr = trainer(agent, cfg, world, mesh, seed=5)
        out[f"{agent}_odd"] = train_step(tr, shard_fn(ep), shard_fn(ep2),
                                         "sample")
    return out


def norm_cases(mesh) -> dict:
    """`global_norm` and one ralamb step (per-parameter trust ratio) of the
    tiny HAMT model split over `mesh`, against the same whole model in
    this process, from the same gradients."""
    from vln_imagine_tpu_torch.config import tiny_test_config
    from vln_imagine_tpu_torch.parallel.tensor import split_of
    from vln_imagine_tpu_torch.train.optim import global_norm, plain_optimizer

    cfg = tiny_test_config("hamt")
    world, _, _ = world_and_episodes(cfg, 2)
    whole, split = (trainer("hamt", cfg, world, m, seed=3).model
                    for m in (None, mesh))
    gen = torch.Generator().manual_seed(0)
    for pw, ps in zip(whole.parameters(), split.parameters()):
        pw.grad = torch.randn(pw.shape, generator=gen)
        sp = split_of(ps)
        ps.grad = pw.grad.clone() if sp is None else sp.local(pw.grad).clone()
    out = {"n_split": sum(split_of(p) is not None for p in split.parameters()),
           "norm": [float(global_norm(list(m.parameters())))
                    for m in (whole, split)]}
    for m in (whole, split):
        plain_optimizer(list(m.parameters()), 1e-2, "ralamb",
                        max_grad_norm=None).step()
    out["ralamb"] = [whole_state(m) for m in (whole, split)]
    return out


def layer_cases(mesh) -> dict:
    """Each way a layer meets a model axis of 2, against the whole layer in
    this process: a Dense split on its output and on its input axis, an
    Embed split on its features and on its rows.  The outputs, and after a
    backward of the same weighted sum the input's gradient and the
    parameters' whole gradients."""
    from vln_imagine_tpu_torch.models.bert import Dense, Embed
    from vln_imagine_tpu_torch.parallel.tensor import (
        ModelShard,
        shard_module,
        split_of,
    )

    shard = ModelShard.of(mesh)
    gen = torch.Generator().manual_seed(0)
    out = {}
    for name, make, dim in (
            ("dense_output", lambda: Dense(6, 8, torch.float32), 0),
            ("dense_input", lambda: Dense(8, 5, torch.float32), 1),
            ("embed_features", lambda: Embed(10, 6, torch.float32), 1),
            ("embed_rows", lambda: Embed(10, 5, torch.float32), 0)):
        whole = make()
        with torch.no_grad():
            for p in whole.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))
        split = make()
        split.load_state_dict(whole.state_dict())
        shard_module(split, shard, {"weight": dim})
        if isinstance(whole, Embed):
            x = torch.randint(0, 10, (3, 4), generator=gen)
            xs = [x, x]
        else:
            x = torch.randn(3, 4, whole.in_features, generator=gen)
            xs = [x.clone().requires_grad_() for _ in range(2)]
        ys = [m(xi) for m, xi in zip((whole, split), xs)]
        w = torch.randn(ys[0].shape, generator=gen)
        for y in ys:
            (y * w).sum().backward()
        grads = [{n: (p.grad if split_of(p) is None
                      else split_of(p).whole(p.grad))
                  for n, p in m.named_parameters()} for m in (whole, split)]
        out[name] = {"y": [y.detach() for y in ys], "grads": grads,
                     "x_grad": [xi.grad for xi in xs],
                     "split": split_of(split.weight) is not None}
    return out


def task_tp_eval(mesh, shard, out_dir):
    from vln_imagine_tpu_torch.parallel.mesh import shard_batch

    return tp_eval_cases(mesh, out_dir, lambda ep: shard_batch(ep, mesh))


def task_tp_train(mesh, shard, out_dir):
    from vln_imagine_tpu_torch.parallel.mesh import shard_batch

    out = train_cases(mesh, out_dir, lambda ep: shard_batch(ep, mesh))
    out["norms"] = norm_cases(mesh)
    out["layers"] = layer_cases(mesh)
    return out


def task_tp_odd(mesh, shard, out_dir):
    from vln_imagine_tpu_torch.parallel.mesh import shard_batch

    def rows(ep):
        return shard_batch(ep, mesh)
    return {"eval": tp_eval_cases(mesh, out_dir, rows, odd=True),
            "train": odd_train_cases(mesh, rows)}


TASKS = {"collectives": task_collectives, "mesh_eval": task_mesh_eval,
         "train": task_train, "driver": task_driver, "tp_eval": task_tp_eval,
         "tp_train": task_tp_train, "tp_odd": task_tp_odd,
         "tp_driver": task_tp_driver, "tp_cfg_driver": task_tp_cfg_driver}


def main(task: str, rank: int, world: int, out_dir: Path,
         model: int = 1) -> None:
    torch.set_num_threads(1)
    from vln_imagine_tpu_torch.parallel import tensor
    from vln_imagine_tpu_torch.parallel.distributed import initialize
    from vln_imagine_tpu_torch.parallel.mesh import DataShard, make_mesh

    tensor.MIN_SIZE = TP_MIN_SIZE
    initialize(f"file://{out_dir / f'{task}_rdzv'}", world, rank,
               device="cpu", timeout=120)
    mesh = make_mesh(data=world // model, model=model)
    out = TASKS[task](mesh, DataShard.of(mesh), out_dir)
    torch.save(out, out_dir / f"{task}_{rank}.pt")
    torch.distributed.destroy_process_group()


def cli_main(argv: list[str]) -> None:
    """The train CLI at `TP_MIN_SIZE`, under a launcher."""
    torch.set_num_threads(1)
    from vln_imagine_tpu_torch.parallel import tensor
    from vln_imagine_tpu_torch.scripts import train as cli

    tensor.MIN_SIZE = TP_MIN_SIZE
    cli.main(argv)


if __name__ == "__main__":
    if sys.argv[1] == "cli":
        cli_main(sys.argv[2:])
    else:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
             Path(sys.argv[4]), *map(int, sys.argv[5:]))
