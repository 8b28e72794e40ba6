"""Classification, decode-execute pipelines and the round trip (port of repro.core)."""
from repro_torch.core.classification import classify_frames  # noqa: F401
from repro_torch.core.fairness import jain_index, min_reward_fairness  # noqa: F401
