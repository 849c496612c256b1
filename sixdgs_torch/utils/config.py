"""Configuration: dataclasses, CLI wiring and the cfg_args parser.

Copy of sixdgs_tpu/utils/config.py: dataclass configs with the
reference's fields and defaults, their CLI wiring, and a small recursive
parser for the persisted ``Namespace(k=v, ...)`` repr, so experiment
directories written by either package (or the reference) are read without
eval. ``ModelConfig.data_device`` defaults to "cuda" here.

As in the JAX package, booleans in cfg_args are parsed as real booleans
(the reference's ANTLR path coerces bool("False") == True, a bug that
inverts persisted False flags).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Dict, List


@dataclass
class ModelConfig:
    """ModelParams parity (arguments/__init__.py:54-69)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = False
    fps_sampling: int = -1


@dataclass
class PipelineConfig:
    """PipelineParams parity (arguments/__init__.py:72-79)."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclass
class OptimizationConfig:
    """OptimizationParams parity (arguments/__init__.py:82-119)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002


@dataclass
class PoseEstimationConfig:
    """Pose-stage hyperparameters (hardcoded in the reference:
    pose_estimation/train.py:27-32, test.py:91, sampling.py:148,
    pretrain_eval_attention.py:166)."""

    n_iterations: int = 1500
    gradient_accumulation_steps: int = 32
    renewal_every_n_iterations: int = 10
    val_every_n_iterations: int = 20
    rays_to_output: int = 100
    quadricell_targets: int = 50
    max_ellipsoids: int = 1000
    knn_normals: int = 20
    ray_budget: int = 32768
    backbone_type: str = "dino"
    lock_backbone: bool = True


def add_dataclass_args(parser, cfg, prefix: str = "") -> None:
    """Register dataclass fields as CLI flags (reflection like ParamGroup,
    arguments/__init__.py:21-51)."""
    for f in dataclasses.fields(cfg):
        name = f"--{prefix}{f.name}"
        default = getattr(cfg, f.name)
        if f.type in (bool, "bool") or isinstance(default, bool):
            parser.add_argument(name, action="store_true", default=default)
        else:
            parser.add_argument(name, type=type(default), default=default)


def extract_dataclass_args(args, cfg_cls):
    kwargs = {}
    for f in dataclasses.fields(cfg_cls):
        if hasattr(args, f.name):
            kwargs[f.name] = getattr(args, f.name)
    return cfg_cls(**kwargs)


# ----------------------------------------------------- cfg_args repr parsing


class _ReprParser:
    """Recursive-descent parser for the Namespace repr persisted by 3DGS
    training (train.py:207-208): ``Namespace(key=value, ...)`` with python
    literals (str/int/float/bool/None/lists/tuples)."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def error(self, msg):
        raise ValueError(f"cfg_args parse error at {self.pos}: {msg}")

    def skip_ws(self):
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1

    def expect(self, s: str):
        self.skip_ws()
        if not self.text.startswith(s, self.pos):
            self.error(f"expected {s!r}")
        self.pos += len(s)

    def peek(self) -> str:
        self.skip_ws()
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def parse(self) -> Dict[str, Any]:
        self.expect("Namespace")
        self.expect("(")
        out: Dict[str, Any] = {}
        if self.peek() == ")":
            self.pos += 1
            return out
        while True:
            key = self.parse_ident()
            self.expect("=")
            out[key] = self.parse_value()
            if self.peek() == ",":
                self.pos += 1
                continue
            self.expect(")")
            return out

    def parse_ident(self) -> str:
        self.skip_ws()
        start = self.pos
        while self.pos < len(self.text) and (
            self.text[self.pos].isalnum() or self.text[self.pos] == "_"
        ):
            self.pos += 1
        if start == self.pos:
            self.error("expected identifier")
        return self.text[start : self.pos]

    def parse_value(self) -> Any:
        c = self.peek()
        if c in "'\"":
            return self.parse_string(c)
        if c in "[(":
            closing = "]" if c == "[" else ")"
            self.pos += 1
            items: List[Any] = []
            if self.peek() == closing:
                self.pos += 1
                return items
            while True:
                items.append(self.parse_value())
                if self.peek() == ",":
                    self.pos += 1
                    if self.peek() == closing:  # trailing comma (tuples)
                        self.pos += 1
                        return items
                    continue
                self.expect(closing)
                return items
        for lit, val in (("True", True), ("False", False), ("None", None)):
            if self.text.startswith(lit, self.pos):
                self.pos += len(lit)
                return val
        # number
        start = self.pos
        while self.pos < len(self.text) and (
            self.text[self.pos] in "+-.eE" or self.text[self.pos].isdigit()
        ):
            self.pos += 1
        token = self.text[start : self.pos]
        if not token:
            self.error("expected value")
        try:
            return int(token)
        except ValueError:
            return float(token)

    def parse_string(self, quote: str) -> str:
        self.expect(quote)
        out = []
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "\\":
                self.pos += 1
                out.append(self.text[self.pos])
            elif c == quote:
                self.pos += 1
                return "".join(out)
            else:
                out.append(c)
            self.pos += 1
        self.error("unterminated string")


def parse_cfg_args(text: str) -> Dict[str, Any]:
    """Parse a persisted cfg_args repr without eval()."""
    return _ReprParser(text).parse()


def read_cfg_args(model_dir: str) -> Dict[str, Any]:
    with open(os.path.join(model_dir, "cfg_args")) as fh:
        return parse_cfg_args(fh.read())


def write_cfg_args(model_dir: str, cfg: Dict[str, Any]) -> None:
    """Persist in the reference repr format (train.py:207-208) so the
    reference tools can read our experiment dirs too."""
    parts = []
    for k in sorted(cfg):
        v = cfg[k]
        parts.append(f"{k}={v!r}")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "cfg_args"), "w") as fh:
        fh.write("Namespace(" + ", ".join(parts) + ")")


class dotdict(dict):
    """dot.notation dict (file_utils.py dotdict parity)."""

    __getattr__ = dict.get
    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__
