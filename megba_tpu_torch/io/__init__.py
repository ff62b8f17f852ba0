"""BAL and g2o file IO and the synthetic scene generator (numpy)."""
