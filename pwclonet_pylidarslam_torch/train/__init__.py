"""Training of PWCLO-Net: loss, train state and steps, trainer."""
