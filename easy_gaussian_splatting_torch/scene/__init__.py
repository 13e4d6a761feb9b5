"""Scene data pipeline. Only the host-side prefetcher is ported so far; the
COLMAP and Blender loaders wait (ROADMAP.md Queue 1)."""
