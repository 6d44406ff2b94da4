"""Scale-out of the correction run: window batches sharded over the cards of
one process (`mesh`), target reads sharded over processes (`dist`)."""
