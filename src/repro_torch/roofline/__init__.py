"""Roofline of the port's steps: ``op_cost`` counts one rank's local ops,
``analysis`` turns the counts into the three roofline terms on the H100's
datasheet constants."""
