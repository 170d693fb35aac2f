"""What every agent's cells share: the seed's world, the configuration
check, and greedy eval over a split of episodes.

Set-up builds everything from the seed: the scan graphs and episodes
(`worldgen`), the view and imagination features (drawn on the device),
and the weights (drawn on the device from the configuration's
`weights_seed`: the stand-in checkpoint every run evaluates); then the
program's own world compile and its trainer, into which the drawn weights
load by name.  The reference draws its own copy again once the window has
closed and the program is freed.  A timed call is one `make_eval_step()` call on one batch of
the split; the batches go round in turn.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from portbench import worldgen
from portbench.reference.common import draw_weights
from portbench.reference.world import Tables


def program_config(config: dict):
    """The port's preset named by the configuration file, held to the
    file's widths: any difference stops the run."""
    from vln_imagine_tpu_torch import config as port_config

    cfg = getattr(port_config, config["preset"])(*config.get("preset_args", []))
    wrong = [f"{sec}.{k}: file {v!r}, program {getattr(getattr(cfg, sec), k)!r}"
             for sec in ("model", "env") for k, v in config[sec].items()
             if getattr(getattr(cfg, sec), k) != v]
    if wrong:
        raise SystemExit("the program's configuration differs from "
                         + config["file"] + ": " + "; ".join(wrong))
    return cfg


class World:
    """The seed's graphs, episodes and features, and the drawn weights."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, specs):
        m, e = config["model"], config["env"]
        self.m, self.e = m, e
        S, N, V = traffic["scans"], traffic["nodes_per_scan"], e["views"]
        self.graphs, paths = worldgen.scan_graphs(seed, S, N)
        self.count = traffic["split"]
        self.ep = worldgen.episodes(
            seed, paths, N, self.count, e["max_gt_path_len"], e["max_instr_len"],
            m["max_imagination_len"], m["vocab_size"], traffic["instructions"])
        self.feat = worldgen.draw_features(seed, (S, N, V, m["image_feat_size"]),
                                           device, stream=0)
        mask = torch.as_tensor(self.ep["imagine_mask"], device=device)
        self.imagine = worldgen.draw_features(
            seed, (self.count, m["max_imagination_len"], m["hidden_size"]),
            device, stream=1) * mask[:, :, None]
        self.specs, self.weights_seed = specs(m), config["weights_seed"]
        self.device = device
        self._tab = None

    def draw_weights(self) -> dict:
        """The drawn weights, anew on the device each call."""
        return draw_weights(self.specs, self.weights_seed, self.device)

    @functools.cached_property
    def weights(self) -> dict:
        """The reference's copy of the weights, drawn on first use: after
        the window, so that no state of the benchmark's shares the card
        with the program's while it is timed."""
        return self.draw_weights()

    def rows(self, idx) -> dict:
        """The episodes `idx` as reference inputs on the device."""
        out = {k: torch.as_tensor(v[idx], device=self.device)
               for k, v in self.ep.items()}
        out["imagine_feats"] = self.imagine[torch.as_tensor(idx, device=self.device)]
        return out

    def tables(self) -> Tables:
        """The reference's own navigation tables (built once, on demand)."""
        if self._tab is None:
            self._tab = Tables(self.graphs, self.e["max_candidates"],
                               self.e["views"], self.device)
        return self._tab


class EvalCell:
    """Greedy eval of `traffic["batch"]` episodes a call; subclasses name
    the trainer (`trainer_class`) and the reference (`specs`)."""

    unit = "episodes"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from vln_imagine_tpu_torch.envx.compiler import ScanGraph, compile_world
        from vln_imagine_tpu_torch.envx.tables import EpisodeBatch

        t0 = time.perf_counter()
        cfg = program_config(config)
        self.w = w = World(config, traffic, seed, device, self.specs)
        t1 = time.perf_counter()
        e = config["env"]
        graphs = [ScanGraph(name, [f"{name}_vp{i:04d}" for i in range(len(xyz))],
                            xyz, edges) for name, xyz, edges in w.graphs]
        world = compile_world(graphs, max_candidates=e["max_candidates"],
                              views=e["views"]).replace(feat=w.feat)
        trainer = self.trainer_class()(cfg, world, device=device,
                                       seed=seed % (2 ** 63))
        trainer.model.load_state_dict(w.draw_weights())
        self.trainer = trainer
        t2 = time.perf_counter()
        B = self.per_call = traffic["batch"]
        if w.count % B:
            raise SystemExit(f"split {w.count} is not a whole number of batches")
        self.batches = []
        for i in range(w.count // B):
            rows = slice(i * B, (i + 1) * B)
            fields = {k: v[rows] for k, v in w.ep.items()}
            fields["imagine_feats"] = w.imagine[rows]
            self.batches.append(EpisodeBatch(**fields).to(device))
        self.eval_step = trainer.make_eval_step()
        self.T = e["max_action_len"]
        # seconds of set-up by part: the benchmark's world and weights, the
        # program's world compile, trainer and weight load, the batches
        self.setup_parts = {"world_and_weights_s": t1 - t0, "program_s": t2 - t1,
                            "batches_s": time.perf_counter() - t2}

    def call(self, i: int):
        return self.eval_step(self.batches[i % len(self.batches)])

    def steps(self, out) -> int:
        return int(self.eval_step.steps)

    def record(self, i: int, out):
        """What the check and the census read of a call, on the host."""
        paths, lens = out[:2]
        return (i % len(self.batches), paths.cpu().numpy(), lens.cpu().numpy())

    def free_program(self):
        del self.trainer, self.batches, self.eval_step

    def items(self, records):
        """Episode index, path and length of every served item."""
        B = self.per_call
        idx = np.concatenate([np.arange(b * B, (b + 1) * B) for b, _, _ in records])
        paths = np.concatenate([p for _, p, _ in records])
        lens = np.concatenate([n for _, _, n in records])
        return idx, paths, lens

    def sample(self, records, seed: int, count: int):
        """`count` served items drawn from the seed, the longest among them."""
        idx, paths, lens = self.items(records)
        rng = np.random.default_rng([seed, 2])
        pick = rng.choice(len(idx), size=min(count, len(idx)), replace=False)
        longest = int(np.argmax(lens))
        if longest not in pick:
            pick[0] = longest
        return idx[pick], paths[pick], lens[pick]
