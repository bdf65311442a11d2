"""The program's models, one module a language model's configuration
``model`` key, which ``portbench/drivers/lm_turn.py`` loads by that name:
``build(config)`` makes the port's model for the configuration file's dict
on the current default device, with ``load_checkpoint(get)`` (``get(name,
shape)`` gives each named tensor) and ``eval()``; the driver loads the
benchmark's weights into it."""
