"""Training: the losses and the train and evaluation steps."""
