"""Optimizer substrate: AdamW with fp32 masters (``adamw``), schedules
(``schedule``), snapshot compression (``grad_compress``)."""
