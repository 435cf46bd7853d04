"""Dense decoder LM: config, parameters, layers, assembly."""
