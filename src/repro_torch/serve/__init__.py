"""LM serving (the ``ServeEngine`` half of ``repro.serve``)."""
