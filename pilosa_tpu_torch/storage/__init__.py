"""Host bitmap storage: the roaring container store and its file codec."""
