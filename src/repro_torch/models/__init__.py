"""Models of the port: the paper's FCNN, and the Zamba2 hybrid LM
(``layers``, ``mamba2``, ``zamba2``) behind ``api.get_model``."""
