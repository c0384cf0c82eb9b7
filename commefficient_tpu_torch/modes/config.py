"""Static configuration for compression modes and server optimizer
semantics: the port's copy of the JAX package's ``modes/config.py``.

The whole ``ModeConfig`` is copied, validation included, so a configuration
means the same thing in both packages; the modes and options the port does
not run yet raise where they would be used (``modes.py``, ``csvec.py``).
"""

from __future__ import annotations

import dataclasses

MODES = ("sketch", "true_topk", "local_topk", "fedavg", "localSGD", "uncompressed")


@dataclasses.dataclass(frozen=True)
class ModeConfig:
    mode: str
    d: int  # flat gradient dimensionality
    k: int = 0  # top-k size (sketch / true_topk / local_topk)
    num_rows: int = 5  # sketch rows r
    num_cols: int = 0  # sketch cols c
    num_blocks: int = 1
    seed: int = 42
    momentum: float = 0.9
    momentum_type: str = "virtual"  # none | virtual | local
    error_type: str = "virtual"  # none | virtual | local
    num_local_iters: int = 1  # fedavg / localSGD local steps
    server_lr: float = 1.0  # weight-delta modes only: scales the averaged
    # delta at the server ("slowmo" server optimizer — with momentum_type=
    # "virtual" the server runs momentum-SGD over round deltas; SURVEY.md §3.1
    # "fedavg: server LR / slowmo optional")
    num_clients: int = 0  # total virtual clients (for local state allocation)
    hash_family: str = "rotation"  # sketch bucket-hash family (see CSVecSpec)
    topk_impl: str = "exact"  # top-k selection; the port runs "exact" only
    # ("approx" and "oversample" are accepted here, as in the reference, and
    # raise in csvec.topk_abs)
    topk_recall: float = 0.95  # recall target of the approximate selections
    server_state: str = "dense"  # server optimizer state: dense [d] vectors
    # or r x c Count-Sketch tables for the top-k-release modes; mode=sketch
    # is sketch-state either way (FetchSGD Alg. 1)
    agg_op: str = "mean"  # how client wires combine: "mean" | "sum".
    # FetchSGD Alg. 1 writes the round sketch as a sum over client sketches
    # (SURVEY.md §3.1) with the scaling absorbed into the learning rate; this
    # library defaults to the mean (an unbiased gradient estimate independent
    # of cohort size). The two are EXACTLY equivalent for every mode here:
    # agg_op="sum" at lr η reproduces agg_op="mean" at lr η·W bit-for-bit
    # (server steps are positively homogeneous: top-k selection is
    # scale-invariant, everything else linear — tested in
    # tests/test_modes.py::test_sum_vs_mean_lr_translation). When reproducing
    # reference CLI hyperparameters (e.g. lr_scale 0.4), use agg_op="sum".
    # Weight-delta modes (fedavg/localSGD) reject "sum": their lr is consumed
    # inside the nonlinear local-SGD loop and the server applies the
    # aggregate at unit rate, so no lr knob can absorb the factor W — a sum
    # of W deltas would just be a W-times-too-large step.

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; expected one of {MODES}")
        if self.mode in ("sketch",) and (self.num_cols <= 0 or self.k <= 0):
            raise ValueError("mode=sketch requires num_cols > 0 and k > 0")
        if self.mode in ("true_topk", "local_topk") and self.k <= 0:
            raise ValueError(f"mode={self.mode} requires k > 0")
        if self.topk_impl not in ("exact", "approx", "oversample"):
            raise ValueError(f"bad topk_impl {self.topk_impl!r}")
        if not (0.0 < self.topk_recall <= 1.0):
            raise ValueError(f"topk_recall must be in (0, 1], got "
                             f"{self.topk_recall}")
        if self.momentum_type not in ("none", "virtual", "local"):
            raise ValueError(f"bad momentum_type {self.momentum_type!r}")
        if self.error_type not in ("none", "virtual", "local"):
            raise ValueError(f"bad error_type {self.error_type!r}")
        if self.agg_op not in ("mean", "sum"):
            raise ValueError(f"bad agg_op {self.agg_op!r}; expected 'mean' or 'sum'")
        if self.server_state not in ("dense", "sketch"):
            raise ValueError(
                f"bad server_state {self.server_state!r}; expected 'dense' "
                "or 'sketch'")
        if self.server_state == "sketch" and self.mode != "sketch":
            if self.mode not in ("true_topk", "local_topk"):
                raise ValueError(
                    f"server_state='sketch' needs a top-k release to stay in "
                    f"sketch space; mode={self.mode!r} releases a dense delta "
                    "(querying every coordinate back out would materialize "
                    "[d] and defeat the O(r*c) state)"
                )
            if self.mode == "local_topk" and self.error_type != "virtual":
                raise ValueError(
                    "server_state='sketch' with mode='local_topk' requires "
                    "error_type='virtual': only the virtual-error branch "
                    "releases a top-k (the others release lr*V densely, "
                    "which a sketch-resident V cannot produce without "
                    "querying every coordinate back out)"
                )
            if self.num_cols <= 0:
                raise ValueError(
                    "server_state='sketch' requires num_cols > 0 (the "
                    "r x c table shape comes from num_rows/num_cols)"
                )
        if self.server_lr != 1.0 and self.mode not in ("fedavg", "localSGD"):
            raise ValueError(
                "server_lr applies only to weight-delta modes (fedavg/localSGD); "
                "grad modes take their server rate from the lr schedule"
            )
        if self.agg_op == "sum" and self.mode in ("fedavg", "localSGD"):
            raise ValueError(
                f"mode={self.mode} requires agg_op='mean': the server applies the "
                "aggregated weight delta at unit rate, so summing W deltas is a "
                "W-times-too-large step with no lr knob to absorb it"
            )
        # Reject combinations the mode library does not implement, rather than
        # silently running a different algorithm than the user configured.
        allowed = {
            "sketch": {"momentum": ("none", "virtual"), "error": ("virtual",)},
            "true_topk": {"momentum": ("none", "virtual"), "error": ("none", "virtual")},
            "local_topk": {"momentum": ("none", "virtual", "local"), "error": ("none", "local", "virtual")},
            "fedavg": {"momentum": ("none", "virtual", "local"), "error": ("none",)},
            "localSGD": {"momentum": ("none", "virtual", "local"), "error": ("none",)},
            "uncompressed": {"momentum": ("none", "virtual"), "error": ("none",)},
        }[self.mode]
        if self.momentum_type not in allowed["momentum"]:
            raise ValueError(
                f"mode={self.mode} supports momentum_type {allowed['momentum']}, "
                f"got {self.momentum_type!r}"
            )
        if self.error_type not in allowed["error"]:
            raise ValueError(
                f"mode={self.mode} supports error_type {allowed['error']}, "
                f"got {self.error_type!r}"
            )

    @property
    def sketch_spec(self):
        from ..sketch.csvec import CSVecSpec

        return CSVecSpec(
            d=self.d, c=self.num_cols, r=self.num_rows, num_blocks=self.num_blocks,
            seed=self.seed, family=self.hash_family,
        )

    @property
    def uses_weight_delta(self) -> bool:
        """fedavg/localSGD clients send weight deltas from >1 local steps; all
        other modes send (transforms of) a single gradient."""
        return self.mode in ("fedavg", "localSGD")

    @property
    def needs_local_state(self) -> bool:
        """Per-client persistent state ([num_clients, d] — the memory wall,
        SURVEY.md §3.3) is only needed for client-side momentum/error."""
        return self.mode == "local_topk" and (
            self.momentum_type == "local" or self.error_type == "local"
        )
