"""Interior-point solver, cone algebra and the chain+arrow KKT backend."""
