"""Moving FedEPM state between the port and numpy (and so the JAX
package)."""
