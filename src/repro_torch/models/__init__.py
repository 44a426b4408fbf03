"""Model families of the port (the dense transformer so far)."""
