"""BAL file IO and the synthetic scene generator (numpy)."""
