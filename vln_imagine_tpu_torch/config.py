"""Typed configuration tree, the port's own copy.

Field names and defaults equal those of the JAX package's config, so a
configuration means the same thing in both packages.  The presets are the
released recipes: `hamt_r2r_config` and `duet_r2r_config` (R2R,
VLN-HAMT/finetune_src/scripts/run_r2r.sh and
VLN-DUET/map_nav_src/scripts/run_r2r.sh), the task variants `rxr_config`,
`r4r_config`, `cvdn_config`, `soon_config` and `reverie_config`,
`soon_butd_config` (SOON with its released 2,048-d object features), and
`tiny_test_config` of either agent.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """Transformer core configuration (the reference's mutated BertConfig,
    VLN-HAMT/finetune_src/models/vlnbert_init.py:37-76)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    pred_head_dropout_prob: float = 0.1
    hidden_act: str = "gelu_erf"  # exact erf gelu (vilmodel_cmt.py:27-33)

    num_l_layers: int = 9
    num_r_layers: int = 0
    num_h_layers: int = 0
    num_x_layers: int = 4
    num_pano_layers: int = 2

    image_feat_size: int = 768
    angle_feat_size: int = 4
    obj_feat_size: int = 0

    max_action_steps: int = 50

    no_lang_ca: bool = False
    update_lang_bert: bool = True
    fix_lang_embedding: bool = False
    fix_hist_embedding: bool = False
    fix_obs_embedding: bool = False
    fix_pano_embedding: bool = False
    fix_local_branch: bool = False
    act_pred_token: str = "ob_txt"  # HAMT head variants (vilmodel_cmt.py:1187-1199)

    graph_sprels: bool = True
    glocal_fuse: bool = True
    use_lang2visn_attn: bool = False
    fusion: str = "dynamic"

    imagine_enc_pano: bool = True
    imagination_data_v2: bool = True
    bypass_imag_encoder: bool = True
    max_imagination_len: int = 20
    use_cosine_aux_loss: bool = True
    aux_loss_type: str = "cosine"  # cosine | infonce | margin
    cosine_weight: float = 0.5
    infonce_temperature: float = 0.3
    contrastive_margin_value: float = 1.0
    concat_imagine_with: str = "language"  # language | visual
    fix_imagine_embeds: bool = False
    fix_lang_inside_cosine_model: bool = False
    no_loss_test: bool = False

    e2e_imagination: str = "off"  # off | frozen | trainable
    e2e_vit_image_size: int = 224
    e2e_vit_patch_size: int = 16
    e2e_vit_layers: int = 12
    e2e_vit_heads: int = 12

    # Numerics: params always f32; matmul/attention compute dtype.
    compute_dtype: str = "bfloat16"
    # Attention routing knobs of the JAX package, kept so a configuration
    # reads the same in both packages.  The port does not read them: every
    # attention call on a CUDA tensor goes to the hand-written kernel.
    use_pallas_attention: bool = True
    pallas_attention_batch_cutoff: int = 64

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class EnvConfig:
    """Compiled-environment capacities (fixed shapes)."""

    views: int = 36
    max_candidates: int = 14
    max_nodes: int = 352
    max_action_len: int = 15
    max_instr_len: int = 60
    max_gt_path_len: int = 8
    max_gmap_nodes: int = 96
    error_margin: float = 3.0
    # 'pano' = candidates + [STOP] + remaining pano views (released configs);
    # 'cand' = candidates + [STOP] only (agent_cmt.py:499-503)
    ob_type: str = "pano"


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-5
    optim: str = "adamw"
    weight_decay: float = 0.0
    batch_size: int = 8
    eval_batch_size: int = 0  # greedy-eval batch size (0 = use batch_size)
    iters: int = 100_000
    log_every: int = 2000
    max_grad_norm: float = 40.0
    feat_dropout: float = 0.4
    # mask action logits of candidates whose node was already visited
    # (parser.py --no_cand_backtrack, agent_cmt.py:549-558)
    no_cand_backtrack: bool = False
    act_visited_nodes: bool = False
    detailed_output: bool = False
    ml_weight: float = 0.2
    teacher_weight: float = 1.0
    gamma: float = 0.9
    entropy_loss_weight: float = 0.01
    normalize_loss: str = "total"
    ignoreid: int = -100
    train_alg: str = "imitation"
    expert_policy: str = "spl"
    expl_sample: bool = False
    expl_max_ratio: float = 0.6
    fused_sample_rollout: bool = False
    experimental_warmup: bool = True
    experimental_warmup_type: str = "variant4"
    warmup_stage1_iters: int = -1
    warmup_stage2_iters: int = -1
    seed: int = 0


@dataclass(frozen=True)
class PretrainConfig:
    tasks: tuple[str, ...] = ("mlm", "sap", "sar", "sprel", "mrc", "itm")
    mix_ratio: tuple[int, ...] = (5, 1, 1, 1, 2, 2)
    lr: float = 5e-5
    batch_size: int = 16
    num_train_steps: int = 200_000
    warmup_steps: int = 10_000
    gradient_accumulation_steps: int = 1
    max_grad_norm: float = 5.0
    log_steps: int = 1000
    valid_steps: int = 5000
    mlm_prob: float = 0.15
    mrc_prob: float = 0.15
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    data_parallelism: int = 0
    model_parallelism: int = 1


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    env: EnvConfig = field(default_factory=EnvConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    pretrain: PretrainConfig = field(default_factory=PretrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    agent: str = "hamt"
    dataset: str = "r2r"

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def _replace(cfg: Config, path: str, **kw: Any) -> Config:
    sub = dataclasses.replace(getattr(cfg, path), **kw)
    return dataclasses.replace(cfg, **{path: sub})


def hamt_r2r_config() -> Config:
    """Released HAMT-Imagine R2R configuration
    (VLN-HAMT/finetune_src/scripts/run_r2r.sh:1-83).  Greedy eval is
    per-item independent, so its batch size is a throughput choice."""
    cfg = Config(agent="hamt")
    cfg = _replace(
        cfg, "model",
        fix_lang_embedding=True, fix_hist_embedding=True,
        max_action_steps=50, act_pred_token="ob_txt",
    )
    cfg = _replace(cfg, "env", max_instr_len=60)
    cfg = _replace(cfg, "train", train_alg="sample", eval_batch_size=64)
    return cfg


def duet_r2r_config() -> Config:
    """Released DUET-Imagine R2R configuration
    (VLN-DUET/map_nav_src/scripts/run_r2r.sh:1-87): DAgger training with the
    SPL expert, a 200-token instruction, dynamic fusion of the two branches
    and the graph's spatial-relation attention bias."""
    cfg = Config(agent="duet")
    cfg = _replace(
        cfg, "model",
        max_action_steps=100, graph_sprels=True, glocal_fuse=True,
        fix_lang_inside_cosine_model=True, fusion="dynamic",
    )
    cfg = _replace(cfg, "env", max_instr_len=200)
    cfg = _replace(cfg, "train", train_alg="dagger", gamma=0.0,
                   eval_batch_size=64)
    return cfg


def rxr_config() -> Config:
    """RxR multilingual preset (HAMT stack, xlm-roberta text:
    vlnbert_init.py:6-11, pretrain config/rxr_xlm_model_config.json).

    RxR guide paths are much longer than R2R's 4-7 nodes (up to ~20), so the
    gt-path buffer and the episode horizon are sized up — a too-small
    max_gt_path_len would silently shift gt_path[-1] off the true goal,
    corrupting the teacher, DTW reward shaping and nDTW/SDTW metrics."""
    cfg = hamt_r2r_config().replace(dataset="rxr")
    cfg = _replace(cfg, "model", vocab_size=250_002,
                   max_position_embeddings=512, type_vocab_size=2)
    cfg = _replace(cfg, "env", max_instr_len=250, max_gt_path_len=20,
                   max_action_len=20)
    return cfg


def r4r_config(agent: str = "duet") -> Config:
    """R4R preset: paths are two joined R2R paths (~10-15 nodes), so the
    gt-path buffer grows while the action horizon stays 15
    (VLN-DUET/map_nav_src/scripts/run_r4r.sh:29,36-37: --expert_policy spl
    --max_action_len 15 --max_instr_len 200)."""
    cfg = (duet_r2r_config() if agent == "duet"
           else hamt_r2r_config()).replace(dataset="r4r")
    cfg = _replace(cfg, "env", max_gt_path_len=16, max_action_len=15,
                   max_instr_len=200 if agent == "duet" else 60)
    return cfg


def cvdn_config() -> Config:
    """CVDN/NDH preset (HAMT stack, finetune_src/cvdn/parser.py:32-33:
    --max_instr_len 80 --max_action_len 15).  NDH supervision paths are the
    full shortest path to a sampled goal pano (cvdn/env.py:30-45) and
    routinely exceed 8 nodes, so the gt-path buffer is sized to the NDH
    path-length distribution; episodes_from_annotations raises (rather than
    silently truncating) if a path still overflows."""
    cfg = hamt_r2r_config().replace(dataset="cvdn")
    cfg = _replace(cfg, "env", max_instr_len=80, max_gt_path_len=25,
                   max_action_len=15)
    return cfg


def soon_config() -> Config:
    """SOON preset (DUET stack, map_nav_src/scripts/run_soon.sh:39-41:
    --max_action_len 20 --max_instr_len 100 --max_objects 100); SOON
    trajectories run longer than R2R's, hence the 20-step horizon and a
    larger gt-path buffer."""
    cfg = reverie_config("duet").replace(dataset="soon")
    cfg = _replace(cfg, "env", max_instr_len=100, max_action_len=20,
                   max_gt_path_len=24)
    return cfg


def soon_butd_config() -> Config:
    """SOON as the release runs it (run_soon.sh: `obj_features=butd`,
    `obj_ft_dim=2048`): `soon_config` with the BUTD detector's 2,048-d
    object features (Faster R-CNN ResNet-101 pooled, Anderson et al., CVPR
    2018) beside the 768-d views, so that the objects go through their own
    projection, `obj_linear` / `obj_layer_norm`.  It keeps REVERIE's single
    imagination (`max_imagination_len` 1), as `soon_config` does."""
    return _replace(soon_config(), "model", obj_feat_size=2048)


def reverie_config(agent: str = "duet") -> Config:
    """REVERIE object-grounding presets.

    agent='duet': DUET stack w/ objects + the single-imagination REVERIE
    variant (map_nav_src/scripts/run_reverie.sh, vilmodel.py:781-888).
    agent='hamt': NavRefCMT (finetune_src/reverie/vlnbert_navref.py) — a
    separate object token segment in the visual stream and a ref_object
    grounding head; the reference NavRef model carries no imagination
    modules, so imagination/aux-loss are off."""
    if agent == "duet":
        cfg = duet_r2r_config().replace(dataset="reverie")
        cfg = _replace(cfg, "model", obj_feat_size=768, max_imagination_len=1)
        # run_reverie.sh: --max_instr_len 200; run_soon.sh uses 100 and
        # --max_objects 100 (override per dataset from the CLI)
        cfg = _replace(cfg, "env", max_instr_len=200)
    else:
        cfg = hamt_r2r_config().replace(dataset="reverie")
        # released NavRef recipe (scripts/run_reverie.sh): --no_lang_ca is
        # PASSED (text never updates through the x-layers) and
        # --fix_lang_embedding/--fix_hist_embedding are NOT (unlike the R2R
        # recipe, REVERIE fine-tunes both); NavRefCMT hardcodes act_logits =
        # next_action(ob * hist[CLS]) (vlnbert_navref.py:150)
        cfg = _replace(cfg, "model", obj_feat_size=768,
                       imagine_enc_pano=False, use_cosine_aux_loss=False,
                       no_lang_ca=True, fix_lang_embedding=False,
                       fix_hist_embedding=False, act_pred_token="ob_hist")
        # finetune_src/scripts/run_reverie.sh: --max_instr_len 60
        cfg = _replace(cfg, "env", max_instr_len=60)
    return cfg


def tiny_test_config(agent: str = "hamt") -> Config:
    """Small shapes for unit tests."""
    presets = {"hamt": hamt_r2r_config, "duet": duet_r2r_config}
    if agent not in presets:
        raise ValueError(f"the port carries the HAMT and DUET presets, not "
                         f"{agent!r}")
    cfg = _replace(
        presets[agent](), "model",
        hidden_size=64, num_attention_heads=4, intermediate_size=128,
        num_l_layers=2, num_x_layers=2, num_pano_layers=1,
        image_feat_size=32, vocab_size=128, max_position_embeddings=64,
        max_imagination_len=4, max_action_steps=16,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        pred_head_dropout_prob=0.0, compute_dtype="float32",
        e2e_vit_image_size=16, e2e_vit_patch_size=8, e2e_vit_layers=2,
        e2e_vit_heads=4,
    )
    cfg = _replace(
        cfg, "env",
        max_candidates=7, max_nodes=24, views=12,
        max_action_len=6, max_instr_len=16, max_gt_path_len=6,
        max_gmap_nodes=24,
    )
    cfg = _replace(cfg, "train", batch_size=2, feat_dropout=0.0)
    return cfg


_SECTIONS = {"model": ModelConfig, "env": EnvConfig, "train": TrainConfig,
             "pretrain": PretrainConfig, "mesh": MeshConfig}


def config_to_json(cfg: Config) -> str:
    """The config as indented JSON (`dataclasses.asdict`), as the JAX
    package writes it."""
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)


def config_from_json(text: str) -> Config:
    """`config_to_json`'s inverse: unknown keys are dropped, lists become
    tuples, and the sections become their dataclasses."""
    def build(cls, data):
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in data.items():
            if k not in names:
                continue
            if isinstance(v, dict) and k in _SECTIONS:
                v = build(_SECTIONS[k], v)
            elif isinstance(v, list):
                v = tuple(v)
            kwargs[k] = v
        return cls(**kwargs)

    return build(Config, json.loads(text))
