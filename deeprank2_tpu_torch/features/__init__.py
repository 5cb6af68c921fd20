"""Feature modules.

Every module exposes ``add_features(pdb_path, graph, single_amino_acid_variant)``
— the same plugin contract as the reference (docs/source/features.md) — but
implementations are vectorized over the graph's node/edge arrays instead of
looping over Python node objects.
"""
