"""Tools that drive the port end to end: the learning proofs on the card."""
