"""Models: the training contract and the tree family."""
