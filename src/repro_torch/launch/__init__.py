"""Entry points and cost models of the LM stack (the reference's
``repro.launch``): the restartable trainer and the H100 roofline terms."""
