"""The program's side of each backend, one module per configuration's
`backend`: `backend_kwargs(config, spec)`, the Scene's backend settings
for one scene description, as the SELD CLI passes them."""
