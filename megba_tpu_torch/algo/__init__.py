"""The Levenberg-Marquardt outer loop."""
