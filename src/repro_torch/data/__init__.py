"""Numpy data generators and partitioners, byte-identical to the JAX
package's."""
