"""Data parallelism over ``torch.distributed`` (the JAX package's parallel/
package): one process a card on the "data" axis of a ("scene", "data")
mesh."""
