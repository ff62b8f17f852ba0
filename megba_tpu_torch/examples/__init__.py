"""The port's example CLIs: the six BAL CLIs and the planar demo (over
common.py), and the pose-graph demos; each runs on the card unless
`--device cpu` is given."""
