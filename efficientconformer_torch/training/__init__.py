"""Training: schedules, optimizers and the trainer of the port."""
