"""Feature-major layout helpers and host-side edge-array helpers."""
