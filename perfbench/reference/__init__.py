"""The plain reference: an LOPC reconstruction (``lopc``) and a reader of
tiled containers (``container``) written from the method's and the
format's definitions, and the comparison that decides ``correct``
(``judge``).  Nothing here imports the program under test."""
