"""Training of the port: optimizers, criterion and the course loop."""
