"""BAL and g2o file IO and the synthetic scene generator (numpy)."""

from megba_tpu_torch.io.synthetic import make_synthetic_bal

__all__ = ["make_synthetic_bal"]
