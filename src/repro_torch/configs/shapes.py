"""The four assigned input shapes + the (arch x shape) applicability matrix."""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def applicability(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per the assignment's skip rules."""
    if cfg.is_encoder and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention; arch is pure full-attention"
    return True, ""


def runnable_cells(configs: dict[str, ModelConfig]) -> list[tuple[str, str]]:
    cells = []
    for arch, cfg in configs.items():
        for sname, shape in SHAPES.items():
            ok, _ = applicability(cfg, shape)
            if ok:
                cells.append((arch, sname))
    return cells
