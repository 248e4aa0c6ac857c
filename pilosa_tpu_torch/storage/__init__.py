"""Host bitmap storage: the in-memory roaring container store."""
