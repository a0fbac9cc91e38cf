"""Graph containers, normalization, reordering and the locality plan."""
