"""Host state (holder, index, field, view, fragment), its data directory,
and device banks."""
