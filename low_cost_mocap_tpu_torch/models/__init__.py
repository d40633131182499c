"""Pipeline assemblies: the per-frame and batched tracking steps."""
