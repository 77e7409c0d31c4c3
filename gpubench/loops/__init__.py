"""Traffic loops, one module each, chosen by a traffic file's ``loop``
key: ``loops/<loop>.py`` defines ``run(coder, traffic, seconds, rng,
stretch) -> Window record``."""
