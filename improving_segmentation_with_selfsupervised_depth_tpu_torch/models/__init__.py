"""Models of the port, in the reference state_dict layout."""
