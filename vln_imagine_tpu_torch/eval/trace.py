"""The benchmark world and episodes of chip_smoke.py's phases, the number
of steps a greedy eval call ran, and the length of a union of device
intervals (`chip_smoke.py:device_busy_ms`).

Where a call's device time goes is read by the benchmark's traced run
(`python3 -m portbench.run --workload <cell> --seed <n> --seconds 30
--trace 1`); a training interval is traced by the driver's
`VLN_PROFILE_DIR`, with the program's spans (utils/spans.py).
"""

from __future__ import annotations

from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world


def bench_world(cfg):
    """bench.py's synthetic world: 2 scans x 96 nodes, 36 views, 768-d."""
    world, _ = synthetic_world(num_scans=2, num_nodes=96,
                               max_candidates=cfg.env.max_candidates, views=36,
                               feat_dim=cfg.model.image_feat_size, seed=0)
    return world


def bench_episodes(world, cfg, batch: int):
    """bench.py's episodes (seed 1) at `batch`."""
    return synthetic_episodes(world, batch=batch,
                              max_gt_path_len=cfg.env.max_gt_path_len,
                              max_instr_len=cfg.env.max_instr_len,
                              max_imaginations=cfg.model.max_imagination_len,
                              vocab_size=cfg.model.vocab_size,
                              feat_dim=cfg.model.hidden_size, seed=1)


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def eval_steps(trainer, ep, path_len) -> int:
    """Steps the greedy eval loop ran.  HAMT records one node a step, so its
    paths say it: the loop breaks after the step at which the last item
    stopped, and an item that stops at step s has path_len s + 1.  A DUET
    step may record several nodes (teleports, the stop-node backtrack), so
    the rollout is run once more for its step count."""
    if trainer.cfg.agent == "hamt":
        return min(int(path_len.max()), trainer.cfg.env.max_action_len)
    from vln_imagine_tpu_torch.train.rollout_duet import rollout_duet

    return rollout_duet(trainer.model, trainer.tables, ep, trainer.cfg,
                        early_exit=True).steps
