"""Training of PWCLO-Net and of PoseResNet: losses, train states and steps,
trainers."""
