"""Configuration system.

The same four dataclasses as ``mtad_gat_tpu/config.py`` (same fields, same
defaults, same validation) and the same ``config.txt`` JSON, so a run
directory written by either package loads in the other. The implementation
names are shared too: ``attention_impl="pallas"`` and ``gru_impl="pallas"``
select this package's hand-written Hopper kernels
(``kernels/gat.py``, ``kernels/gru.py``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from mtad_gat_tpu_torch.graph.structure import parse_graph_spec

# gru_impl="auto" switches to the fused GRU scan kernels at this window size.
# Measured on an NVIDIA H100 80GB HBM3 at 700.00 W by chip_smoke.py (phase
# gru_crossover; the table is in PERF.md): at batch 256, hidden 150, float32
# the kernels beat the plain per-step loop at every window from 2 up, for
# scoring and for training, in every run, because the loop is bound by the
# host's launches; at window 1 training is a tie within the host's noise.
# The JAX package keeps its own value, measured on its own hardware.
GRU_PALLAS_MIN_WINDOW = 2


@dataclass
class MTADGATConfig:
    """Model hyper-parameters (reference ``args.py:26-42`` model group)."""

    n_features: int = 38
    window_size: int = 100          # --lookback
    out_dim: int = 38
    kernel_size: int = 7
    use_gatv2: bool = True
    feat_gat_embed_dim: Optional[int] = None
    time_gat_embed_dim: Optional[int] = None
    gru_n_layers: int = 1
    gru_hid_dim: int = 150
    forecast_n_layers: int = 3      # --fc_n_layers
    forecast_hid_dim: int = 150     # --fc_hid_dim
    recon_n_layers: int = 1
    recon_hid_dim: int = 150
    dropout: float = 0.3
    alpha: float = 0.2              # leaky-relu negative slope

    # Compute dtype of the forward pass ("float32" or "bfloat16"); params
    # always live in float32.
    compute_dtype: str = "float32"
    # "dense" (plain tensor ops; a complete GATv2 graph too large for them
    # goes to the fused kernel, nn/gat.dense_route), "sparse" (the COO
    # path), "pallas" (the fused attention kernel) or "ring" (GATv2 on a
    # complete graph with its node axis split over a mesh's model axis,
    # parallel/ring_attention.py; on a band:W graph, GATv2 or GATv1, the
    # halo exchange, parallel/banded_halo.py; the single-device paths
    # without such a mesh).
    attention_impl: str = "dense"
    # recompute both attention layers in the backward pass of a training
    # call, keeping only each layer's input, parameters and dropout draw
    # (nn/remat.py; the JAX package's nn.remat): trades a second forward of
    # each layer for its residuals, the dense path's (b, N, N) scores
    # above all; on the solo, fleet and mesh training paths, with the same
    # bits as without it; eval and no-grad calls are unchanged
    remat_attention: bool = False
    # "auto", "xla" (per-step loop of tensor ops) or "pallas" (the fused
    # GRU scan kernels, forward and backward); "auto" resolves by window size.
    gru_impl: str = "auto"
    gru_unroll: int = 4
    feature_graph: str = "complete"
    temporal_graph: str = "complete"
    feature_edges: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None
    bias_storage: str = "full"

    def __post_init__(self):
        if self.attention_impl not in ("dense", "sparse", "pallas", "ring"):
            raise ValueError(
                f"attention_impl must be dense|sparse|pallas|ring, "
                f"got {self.attention_impl!r}"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32|bfloat16, "
                f"got {self.compute_dtype!r}"
            )
        if self.gru_impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"gru_impl must be auto|xla|pallas, got {self.gru_impl!r}"
            )
        if self.gru_unroll < 1:
            raise ValueError(f"gru_unroll must be >= 1, got {self.gru_unroll}")

        fkind, _ = parse_graph_spec(self.feature_graph)
        tkind, _ = parse_graph_spec(self.temporal_graph)
        if fkind == "band":
            raise ValueError(
                "feature_graph must be 'complete' or 'knn:K' (banded topology "
                "only makes sense on the ordered temporal axis)"
            )
        if tkind == "knn":
            raise ValueError(
                "temporal_graph must be 'complete' or 'band:W' (k-NN topology "
                "is data-driven over features)"
            )
        if (
            self.attention_impl == "ring" and not self.use_gatv2
            and tkind != "band"
        ):
            raise ValueError(
                "attention_impl='ring' requires use_gatv2=True (the "
                "complete-graph ring path is GATv2-only; banded temporal "
                "graphs support both via halo exchange)"
            )
        if self.attention_impl == "pallas" and not self.use_gatv2:
            raise ValueError(
                "attention_impl='pallas' requires use_gatv2=True (the fused "
                "kernel implements GATv2 scoring only; with use_gatv2=False "
                "use 'dense' or 'sparse')"
            )
        if (
            (fkind != "complete" or tkind != "complete")
            and self.attention_impl not in ("dense", "sparse", "ring")
        ):
            raise ValueError(
                "non-complete graph topologies run through the COO sparse, "
                "banded-dense, or halo paths; set attention_impl to "
                f"'dense', 'sparse', or 'ring' (got {self.attention_impl!r})"
            )
        if self.bias_storage not in ("full", "band"):
            raise ValueError(
                f"bias_storage must be full|band, got {self.bias_storage!r}"
            )
        if self.bias_storage == "band" and tkind != "band":
            raise ValueError(
                "bias_storage='band' stores the banded temporal score bias; "
                "it requires temporal_graph='band:W'"
            )
        if self.feature_edges is not None:
            src, dst = self.feature_edges
            self.feature_edges = (
                tuple(int(s) for s in src),
                tuple(int(d) for d in dst),
            )

    def resolved_gru_impl(self) -> str:
        """Resolve gru_impl="auto" by window size (GRU_PALLAS_MIN_WINDOW)."""
        if self.gru_impl != "auto":
            return self.gru_impl
        return "pallas" if self.window_size >= GRU_PALLAS_MIN_WINDOW else "xla"

    def feat_embed_dim(self) -> int:
        """Effective feature-GAT embed dim (doubled for GATv2, reference
        ``modules.py:41,47-48``)."""
        e = self.feat_gat_embed_dim if self.feat_gat_embed_dim is not None else self.window_size
        return 2 * e if self.use_gatv2 else e

    def time_embed_dim(self) -> int:
        """Effective temporal-GAT embed dim (reference ``modules.py:143,148-149``)."""
        e = self.time_gat_embed_dim if self.time_gat_embed_dim is not None else self.n_features
        return 2 * e if self.use_gatv2 else e


@dataclass
class TrainConfig:
    """Training-loop parameters (reference ``args.py:44-53`` train group)."""

    epochs: int = 30
    val_split: float = 0.1
    bs: int = 256
    init_lr: float = 1e-3
    shuffle_dataset: bool = True
    use_cuda: bool = True
    print_every: int = 1
    log_tensorboard: bool = True
    seed: int = 0
    grad_clip_norm: Optional[float] = None
    lr_schedule: str = "constant"   # "constant" | "cosine" | "warmup_cosine"
    lr_warmup_steps: int = 0
    lr_decay_steps: int = 10000
    profile_dir: str = ""
    checkpoint_every: int = 1


@dataclass
class PredictConfig:
    """Scoring / thresholding parameters (reference ``args.py:55-61``)."""

    scale_scores: bool = False
    use_mov_av: bool = False
    gamma: float = 1.0
    level: Optional[float] = None
    q: Optional[float] = None
    dynamic_pot: bool = False


@dataclass
class RunConfig:
    """Full run configuration = the reference's argparse namespace
    (``args.py:15-66``), JSON round-trippable like ``config.txt``."""

    dataset: str = "SMD"
    group: str = "1-1"
    lookback: int = 100
    normalize: bool = True
    spec_res: bool = False

    kernel_size: int = 7
    use_gatv2: bool = True
    feat_gat_embed_dim: Optional[int] = None
    time_gat_embed_dim: Optional[int] = None
    gru_n_layers: int = 1
    gru_hid_dim: int = 150
    fc_n_layers: int = 3
    fc_hid_dim: int = 150
    recon_n_layers: int = 1
    recon_hid_dim: int = 150
    alpha: float = 0.2

    epochs: int = 30
    val_split: float = 0.1
    bs: int = 256
    init_lr: float = 1e-3
    shuffle_dataset: bool = True
    dropout: float = 0.3
    use_cuda: bool = True
    print_every: int = 1
    log_tensorboard: bool = True

    scale_scores: bool = False
    use_mov_av: bool = False
    gamma: float = 1.0
    level: Optional[float] = None
    q: Optional[float] = None
    dynamic_pot: bool = False

    comment: str = ""

    seed: int = 0
    compute_dtype: str = "float32"
    attention_impl: str = "dense"
    gru_impl: str = "auto"
    gru_unroll: int = 4
    data_root: str = "datasets"
    output_root: str = "output"
    feature_graph: str = "complete"
    temporal_graph: str = "complete"
    feature_edges: Optional[List[List[int]]] = None
    bias_storage: str = "full"

    mesh_devices: int = 0
    model_parallel: int = 0
    coordinator: str = ""
    num_processes: int = 0
    process_id: int = -1

    profile_dir: str = ""
    checkpoint_every: int = 1
    run_id: str = ""
    auto_resume: bool = False

    # ------------------------------------------------------------------
    def model_config(self, n_features: int, out_dim: int) -> MTADGATConfig:
        return MTADGATConfig(
            n_features=n_features,
            window_size=self.lookback,
            out_dim=out_dim,
            kernel_size=self.kernel_size,
            use_gatv2=self.use_gatv2,
            feat_gat_embed_dim=self.feat_gat_embed_dim,
            time_gat_embed_dim=self.time_gat_embed_dim,
            gru_n_layers=self.gru_n_layers,
            gru_hid_dim=self.gru_hid_dim,
            forecast_n_layers=self.fc_n_layers,
            forecast_hid_dim=self.fc_hid_dim,
            recon_n_layers=self.recon_n_layers,
            recon_hid_dim=self.recon_hid_dim,
            dropout=self.dropout,
            alpha=self.alpha,
            compute_dtype=self.compute_dtype,
            attention_impl=self.attention_impl,
            gru_impl=self.gru_impl,
            gru_unroll=self.gru_unroll,
            feature_graph=self.feature_graph,
            temporal_graph=self.temporal_graph,
            feature_edges=(
                None if self.feature_edges is None
                else (tuple(self.feature_edges[0]), tuple(self.feature_edges[1]))
            ),
            bias_storage=self.bias_storage,
        )

    def train_config(self) -> TrainConfig:
        return TrainConfig(
            epochs=self.epochs,
            val_split=self.val_split,
            bs=self.bs,
            init_lr=self.init_lr,
            shuffle_dataset=self.shuffle_dataset,
            use_cuda=self.use_cuda,
            print_every=self.print_every,
            log_tensorboard=self.log_tensorboard,
            seed=self.seed,
            profile_dir=self.profile_dir,
            checkpoint_every=self.checkpoint_every,
        )

    def predict_config(self) -> PredictConfig:
        return PredictConfig(
            scale_scores=self.scale_scores,
            use_mov_av=self.use_mov_av,
            gamma=self.gamma,
            level=self.level,
            q=self.q,
            dynamic_pot=self.dynamic_pot,
        )

    # --- JSON round-trip (reference train.py:170-172 / predict.py:53-55) ---
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        if "gru_impl" not in kw:
            # config.txt saved before gru_impl existed: those runs scored
            # with the plain scan, so pin it rather than backfilling "auto"
            kw["gru_impl"] = "xla"
        return cls(**kw)

    @classmethod
    def load(cls, path: str) -> "RunConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# Per-dataset threshold-parameter tables, hardcoded in the reference entry
# scripts (train.py:126-143, predict.py:126-144).
LEVEL_Q_TABLE: Dict[str, Tuple[float, float]] = {
    "SMAP": (0.90, 0.005),
    "MSL": (0.90, 0.001),
    "SMD-1": (0.9950, 0.001),
    "SMD-2": (0.9925, 0.001),
    "SMD-3": (0.9999, 0.001),
}

REG_LEVEL_TABLE: Dict[str, int] = {
    "SMAP": 0,
    "MSL": 0,
    "SMD-1": 1,
    "SMD-2": 1,
    "SMD-3": 1,
}


def lookup_pot_params(dataset: str, group: str, level: Optional[float], q: Optional[float]):
    """Resolve (level, q, reg_level) like reference train.py:126-143."""
    key = "SMD-" + group[0] if dataset == "SMD" else dataset
    lvl, qq = LEVEL_Q_TABLE[key]
    if level is not None:
        lvl = level
    if q is not None:
        qq = q
    reg_level = REG_LEVEL_TABLE[key]
    return lvl, qq, reg_level
