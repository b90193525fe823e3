"""Scale-out over ranks (`mesh`)."""
