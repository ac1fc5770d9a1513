"""Worker functions the gang tests run in each process of a gloo world.
They import torch and the port only."""
