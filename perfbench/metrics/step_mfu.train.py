"""Model: the training step's model FLOPs (``weights.model_flops_per_token``)
over the time of the window's steps after the traced stretch, against the
H100's 989 TFLOP/s bf16 peak, in %; the card's power limit is noted."""
from perfbench import weights, work


def read(record):
    part = record["window"]["untraced"]
    if not part:
        return None
    cell = record["cell"]
    per_token = weights.model_flops_per_token(cell.config,
                                              cell.traffic["seq_len"])
    value = work.mfu_percent(per_token, part["tokens"], part["seconds"])
    card = record.get("card") or {}
    return value, f"against 989 TFLOP/s; power limit {card.get('power_limit_w')} W"
